"""Data loaders of the port."""
