"""Fault-tolerant streaming sketch sessions.

Counterpart of ``tt_sketch_tpu/streaming.py``.  ``StreamingSketchSession``
consumes an ordered stream of tensor pieces (summands, nnz shards from
``SparseTensor.split``, dense slabs, ...) one piece at a time against fixed
seed-derived DRMs; the accumulated container is checkpointed atomically
every ``checkpoint_every`` pieces together with a progress cursor.  After a
crash, ``StreamingSketchSession.resume`` reloads the last good checkpoint
and reports how many pieces were already consumed, so the caller re-feeds
only the tail of the stream.  The result equals an uninterrupted run bit
for bit wherever each piece's sketch is deterministic: the container is a
pure sum, added in the same order, and the DRMs regenerate exactly from
their seeds.

The DRMs are derived from the seed as in the JAX package (the right seed by
``_derive_right_seed``), so a session checkpointed by the JAX package
resumes here and goes on with the same DRMs.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Type, Union

import numpy as np

from tt_sketch_torch.drm import TensorTrainDRM
from tt_sketch_torch.drm.base import DRM
from tt_sketch_torch.engine.sketch import (
    SketchedTensorTrain,
    _derive_right_seed,
    stream_sketch,
)
from tt_sketch_torch.serialization import load_sketch, save_sketch
from tt_sketch_torch.utils import process_tt_rank


class StreamingSketchSession:
    """Accumulate a streaming sketch over tensor pieces, with checkpoints.

    >>> session = StreamingSketchSession(
    ...     shape, left_rank=10, right_rank=20, seed=7,
    ...     checkpoint_path="stream.npz", checkpoint_every=10)
    >>> for piece in pieces[session.n_consumed:]:   # 0 on a fresh start
    ...     session.consume(piece)
    >>> tt = session.result().to_tt()

    The DRMs are built with ``dtype`` on ``device`` (default: the package
    default device); the pieces must lie there with that dtype.
    """

    def __init__(
        self,
        shape,
        left_rank,
        right_rank,
        seed: int = 0,
        *,
        left_drm_type: Optional[Type[DRM]] = None,
        right_drm_type: Optional[Type[DRM]] = None,
        dtype=None,
        device=None,
        checkpoint_path: Optional[Union[str, Path]] = None,
        checkpoint_every: int = 1,
        _state: Optional[tuple] = None,
    ):
        self.shape = tuple(int(s) for s in shape)
        d = len(self.shape)
        self.checkpoint_path = (
            Path(checkpoint_path) if checkpoint_path is not None else None
        )
        self.checkpoint_every = int(checkpoint_every)
        if _state is not None:
            self._sketched, self.n_consumed = _state
            return
        right_bigger = bool(
            np.all(np.array(left_rank) < np.array(right_rank))
        )
        left_rank = process_tt_rank(left_rank, self.shape, trim=right_bigger)
        right_rank = process_tt_rank(
            right_rank, self.shape, trim=not right_bigger
        )
        left_drm_type = left_drm_type or TensorTrainDRM
        right_drm_type = right_drm_type or TensorTrainDRM
        left_drm = left_drm_type(
            left_rank, shape=self.shape, transpose=False, seed=seed,
            dtype=dtype, device=device,
        )
        right_drm = right_drm_type(
            right_rank, shape=self.shape, transpose=True,
            seed=_derive_right_seed(seed, d), dtype=dtype, device=device,
        )
        self._sketched: Optional[SketchedTensorTrain] = None
        self._drms = (left_drm, right_drm)
        self.n_consumed = 0

    # -- streaming ----------------------------------------------------------

    def consume(self, tensor) -> "StreamingSketchSession":
        """Sketch one piece and fold it into the running container."""
        if tuple(tensor.shape) != self.shape:
            raise ValueError(
                f"piece shape {tuple(tensor.shape)} != session shape "
                f"{self.shape}"
            )
        if self._sketched is None:
            left_drm, right_drm = self._drms
            self._sketched = stream_sketch(
                tensor,
                left_drm.rank,
                right_drm.rank[::-1],
                left_drm=left_drm,
                right_drm=right_drm,
            )
        else:
            # exact linear update with the same DRMs (sketch linearity)
            self._sketched = self._sketched + tensor
        self.n_consumed += 1
        if (
            self.checkpoint_path is not None
            and self.n_consumed % self.checkpoint_every == 0
        ):
            self.checkpoint()
        return self

    def checkpoint(self) -> None:
        """Atomically persist the container + progress cursor."""
        if self.checkpoint_path is None:
            raise ValueError("session has no checkpoint_path")
        if self._sketched is None:
            raise ValueError("nothing consumed yet")
        save_sketch(
            self.checkpoint_path,
            self._sketched,
            extra={"kind": "streaming_session", "n_consumed": self.n_consumed},
        )

    def result(self) -> SketchedTensorTrain:
        if self._sketched is None:
            raise ValueError("nothing consumed yet")
        return self._sketched

    # -- recovery -----------------------------------------------------------

    @classmethod
    def resume(
        cls,
        checkpoint_path: Union[str, Path],
        checkpoint_every: Optional[int] = None,
        device=None,
    ) -> "StreamingSketchSession":
        """Reload the last good checkpoint onto ``device`` (default: the
        package default); ``.n_consumed`` tells the caller where to restart
        its stream."""
        sketched, extra = load_sketch(checkpoint_path, with_extra=True,
                                      device=device)
        if extra.get("kind") != "streaming_session":
            raise ValueError(
                f"{checkpoint_path} is not a streaming-session checkpoint"
            )
        return cls(
            sketched.shape,
            sketched.left_rank,
            sketched.right_rank,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every or 1,
            _state=(sketched, int(extra["n_consumed"])),
        )
