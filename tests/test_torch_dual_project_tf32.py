"""The arithmetic that the projection kernel (``csrc/dual_project.cu``)
relies on, emulated with numpy on the CPU.

The kernel multiplies on the TF32 tensor cores.  In f32 mode it splits each
operand ``x = big + small``, ``big`` = x rounded to TF32 as
``cvt.rna.tf32.f32`` rounds (10 mantissa bits, nearest, ties away from
zero), ``small`` = the same rounding of ``x - big``, and sums three
products (3xTF32, small·small dropped); in bf16 mode it rounds the operands
to bfloat16, which TF32 holds exactly, and takes one product.  The kernel
computes the rounding with an integer add and mask; ``kernel_tf32`` is that
formula, held here to ``tf32_rna``, which rounds by value.

Tolerances: ``F32_TOL`` is the card check's (``chip_smoke.py``), 2e-5
relative Frobenius; 3xTF32 must keep a tenth of it at the main path's
contraction lengths (16384 and 32768), where one TF32 pass is off by about
3e-4.  Against the JAX package's Pallas kernel (interpret mode), the
emulation is held to ``F32_TOL`` (fp32 sums in another order; in bf16 mode
both sides multiply the same bf16 operands exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

F32_TOL = 2e-5
MAIN_K = (16384, 32768)  # the main path's contractions: S for T, P for U


def tf32_rna(x) -> np.ndarray:
    """``cvt.rna.tf32.f32`` by value: the nearest multiple of the TF32
    quantum (2^(e - 10) for 2^e <= |x| < 2^(e + 1), 2^-136 below the
    smallest normal), ties away from zero; float32 in and out."""
    x = np.asarray(x, dtype=np.float32)
    a = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    quantum = np.exp2(np.maximum(e, -126) - 10)
    y = np.copysign(np.floor(a / quantum + 0.5) * quantum, x)
    with np.errstate(over="ignore"):
        return np.where(np.isfinite(x), y, x).astype(np.float32)


def kernel_tf32(x) -> np.ndarray:
    """The kernel's rounding (``tf32_unmasked(x) & 0xffffe000``): half a
    TF32 ulp added to the magnitude bits, the low 13 bits dropped."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """(big, small) of 3xTF32."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def three_tf32(a, b):
    """a @ b from the three TF32 products, each exact, summed in float64."""
    (ab, as_), (bb, bs) = split(a), split(b)
    f = np.float64
    return as_.astype(f) @ bb.astype(f) + ab.astype(f) @ bs.astype(f) \
        + ab.astype(f) @ bb.astype(f)


def bf16(x) -> np.ndarray:
    """x rounded to bfloat16 (nearest, ties to even), back in float32, as
    the port's ``rounded_operands`` does."""
    t = torch.from_numpy(np.asarray(x, dtype=np.float32).copy())
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bit_patterns(kind, rng, n=20000):
    if kind == "uniform bits":
        b = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        x = b.view(np.float32)
        return x[np.isfinite(x)]
    if kind == "ties":
        b = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        b = (b & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
        x = b.view(np.float32)
        return x[np.isfinite(x)]
    if kind == "next to ties":
        b = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        b = (b & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
        x = np.concatenate([(b - np.uint32(1)).view(np.float32),
                            (b + np.uint32(1)).view(np.float32)])
        return x[np.isfinite(x)]
    if kind == "subnormal":
        b = rng.integers(0, 2**23, size=n).astype(np.uint32)
        return np.concatenate([b.view(np.float32), -b.view(np.float32)])
    if kind == "carry into the exponent":
        e = rng.integers(1, 254, size=n).astype(np.uint32) << np.uint32(23)
        b = e | np.uint32(0x7FF000 + 0xFFF) - rng.integers(
            0, 0x1000, size=n).astype(np.uint32)
        return np.concatenate([b.view(np.float32), -b.view(np.float32)])
    if kind == "special":
        return np.array([0.0, -0.0, 1.0, -1.0, 2.0**-126, 2.0**-149,
                         np.finfo(np.float32).max, -np.finfo(np.float32).max,
                         np.finfo(np.float32).tiny, 65504.0, 1 + 2.0**-11,
                         1 + 3 * 2.0**-11], dtype=np.float32)
    raise ValueError(kind)


BIT_KINDS = ["uniform bits", "ties", "next to ties", "subnormal",
             "carry into the exponent", "special"]


@pytest.mark.parametrize("kind", BIT_KINDS)
def test_kernel_rounding_is_cvt_rna_tf32(kind):
    """The kernel's integer add and mask gives the bits of round-to-nearest,
    ties away from zero, at 10 mantissa bits, on every finite float32 kind,
    ties and carries into the exponent included."""
    x = _bit_patterns(kind, np.random.default_rng(BIT_KINDS.index(kind)))
    want, got = tf32_rna(x), kernel_tf32(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (want.view(np.uint32) & np.uint32(0x1FFF)).any()


@pytest.mark.parametrize("kind", ["ties", "next to ties"])
def test_ties_round_away_from_zero(kind):
    x = _bit_patterns(kind, np.random.default_rng(7))
    x = x[np.isfinite(x) & (np.abs(x) >= np.finfo(np.float32).tiny)]
    r = tf32_rna(x).astype(np.float64)
    d = np.abs(r - x.astype(np.float64))
    quantum = np.exp2(np.floor(np.log2(np.abs(x.astype(np.float64)))) - 10)
    assert (d <= quantum / 2).all()
    if kind == "ties":
        assert (np.abs(r) > np.abs(x.astype(np.float64))).all()


@pytest.mark.parametrize("K", MAIN_K)
@pytest.mark.parametrize("shape", [(4, 8), (8, 2)])
def test_three_tf32_products_keep_fp32_accuracy(K, shape):
    """3xTF32 is within F32_TOL / 10 of the float64 product at the main
    path's contraction lengths; one TF32 pass is not."""
    M, N = shape
    rng = np.random.default_rng(K + M)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(three_tf32(a, b), exact) <= F32_TOL / 10
    one = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    assert _rel(one, exact) > F32_TOL / 10


@pytest.mark.parametrize("K", MAIN_K)
def test_three_tf32_with_fp32_tile_sums(K):
    """The same with the kernel's sums in fp32: each k-step of 8 rounded to
    fp32 into a fresh accumulator per tile of 128, each tile added to the
    running fp32 sum."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((4, K)).astype(np.float32)
    b = rng.standard_normal((K, 8)).astype(np.float32)
    (ab, as_), (bb, bs) = split(a), split(b)
    f = np.float64
    steps = sum(np.einsum("mst,stn->smn", x.astype(f).reshape(4, -1, 8),
                          y.astype(f).reshape(-1, 8, 8))
                for x, y in ((as_, bb), (ab, bs), (ab, bb)))
    steps = steps.astype(np.float32)
    total = np.zeros((4, 8), np.float32)
    for tile in steps.reshape(-1, 16, 4, 8):
        part = np.zeros((4, 8), np.float32)
        for step in tile:
            part = part + step
        total = total + part
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert total.dtype == np.float32
    assert _rel(total, exact) <= F32_TOL / 10


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_bf16_values_are_fixed_points_of_tf32(scale):
    """Every bf16-rounded value (8 significant bits) is exact in TF32 (11):
    the bf16 mode's single product loses nothing to the tensor cores."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = bf16(rng.standard_normal(50000) * scale)
    for rounding in (tf32_rna, kernel_tf32):
        assert np.array_equal(rounding(x).view(np.uint32), x.view(np.uint32))


def test_bf16_bit_patterns_are_fixed_points_of_tf32():
    """The same over every finite bf16 bit pattern."""
    b = (np.arange(2**16, dtype=np.uint32) << np.uint32(16))
    x = b.view(np.float32)
    x = x[np.isfinite(x)]
    for rounding in (tf32_rna, kernel_tf32):
        assert np.array_equal(rounding(x).view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_emulated_kernel_arithmetic_vs_pallas_interpret(compute):
    """T and U from the kernel's products, emulated, against the JAX
    package's dual_project (Pallas kernel in interpret mode) and the port's
    plain version on the same inputs."""
    from tt_sketch_tpu.kernels.pallas_project import dual_project as j_dual
    from tt_sketch_torch.kernels import dual_project as dp

    rng = np.random.default_rng(3)
    P, S, r, rho = 256, 4096, 32, 64
    X = rng.normal(size=(P, S)).astype(np.float32)
    R = rng.normal(size=(S, rho)).astype(np.float32)
    L = rng.normal(size=(P, r)).astype(np.float32)
    if compute == "bf16":
        Xr, Rr, Lr = (bf16(m).astype(np.float64) for m in (X, R, L))
        T, U = Xr @ Rr, Lr.T @ Xr
    else:
        T, U = three_tf32(X, R), three_tf32(L.T.copy(), X)
    mxu = jnp.bfloat16 if compute == "bf16" else jnp.float32
    T0, U0 = j_dual(jnp.asarray(X), jnp.asarray(R), jnp.asarray(L),
                    block_m=128, block_n=2048, mxu_dtype=mxu, interpret=True)
    T1, U1 = dp.dual_project_reference(
        torch.from_numpy(X), torch.from_numpy(R), torch.from_numpy(L),
        compute=compute)
    for got, ref in ((T, np.asarray(T0)), (U, np.asarray(U0)),
                     (T, T1.numpy()), (U, U1.numpy())):
        assert _rel(got.astype(np.float32), ref) <= F32_TOL
