"""The port's RMSNorm (`repro_torch.kernels.rmsnorm`: the plain version the
wrapper sends CPU tensors to, and the autograd function of `ops`) against
`repro.kernels.rmsnorm`: the jnp oracle `rmsnorm_ref`, the Pallas kernel
in interpret mode (as tests/test_kernels.py runs it on the CPU), and
`jax.vjp` of the ops dispatch the FL path differentiates. Inputs are made
with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rmsnorm as r_pallas
from repro.kernels.rmsnorm.ops import rmsnorm as r_ops
from repro.kernels.rmsnorm.ref import rmsnorm_ref as r_ref
from repro_torch.kernels.rmsnorm import kernel as TK
from repro_torch.kernels.rmsnorm.ops import rmsnorm as t_ops
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_ref,
                                             rmsnorm_fwd_ref, rmsnorm_ref)

EPS = 1e-6
# float32: the same float32 arithmetic in another order (the float32
# tolerance of tests/test_kernels.py)
F32 = dict(rtol=2e-5, atol=2e-5)
# bfloat16 against the oracle, which casts before it scales while the
# kernel (and the port) scales in float32 and casts once (ROADMAP C4):
# one bfloat16 rounding apart (the bfloat16 tolerance of test_kernels.py)
BF16_ORACLE = dict(rtol=3e-2, atol=3e-2)
# bfloat16 against the Pallas interpreter, which scales in float32 and
# casts once like the port: equal up to a flip of the final rounding
# (2^-8 relative)
BF16_PALLAS = dict(rtol=1e-2, atol=1e-2)


def _inputs(shape, groups=(), seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32)
    s = (1.0 + 0.5 * r.standard_normal(groups + (shape[-1],))).astype(
        np.float32)
    dy = r.standard_normal(shape).astype(np.float32)
    return x, s, dy


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("shape", [(4, 128), (3, 5, 256), (37, 512),
                                   (32, 8, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_oracle_and_pallas(shape, dtype):
    """The sweep of tests/test_kernels.py plus the transformer payload's
    hidden states (B, S, d_model) = (32, 8, 32)."""
    x, s, _ = _inputs(shape, seed=len(shape))
    jx, js = jnp.asarray(x, dtype), jnp.asarray(s, dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    ts = torch.tensor(s).to(getattr(torch, dtype))
    y_ops = t_ops(tx, ts, EPS)
    y_wrap, rstd = TK.rmsnorm(tx, ts, EPS)       # CPU -> plain version
    assert y_ops.dtype == tx.dtype and y_ops.shape == tx.shape
    assert rstd.shape == (x.size // shape[-1],)
    np.testing.assert_array_equal(_f32(y_wrap), _f32(y_ops))
    oracle = _f32(r_ref(jx, js, EPS))
    pallas = _f32(r_pallas(jx, js, EPS, rows=8, interpret=True))
    f32 = dtype == "float32"
    np.testing.assert_allclose(_f32(y_ops), oracle,
                               **(F32 if f32 else BF16_ORACLE))
    np.testing.assert_allclose(_f32(y_ops), pallas,
                               **(F32 if f32 else BF16_PALLAS))


@pytest.mark.parametrize("shape", [(3, 40, 32), (4, 2, 8, 16)])
def test_batched_scale_matches_vmap(shape):
    """x (G, ..., D) with one scale row per group: what the reference gets
    from `vmap` over satellites, each with its own (D,) scale."""
    x, s, _ = _inputs(shape, groups=(shape[0],), seed=7)
    ref = jax.vmap(lambda a, b: r_ref(a, b, EPS))(jnp.asarray(x),
                                                  jnp.asarray(s))
    got = t_ops(torch.tensor(x), torch.tensor(s), EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_gradients_match_jax_vjp(batched):
    """dx and dscale for a random cotangent, against `jax.vjp` of the ops
    dispatch (the oracle off the TPU, which the reference's client update
    differentiates), at the payload's training shape (G satellites x 32
    samples x 8 tokens x d_model 32). Checked for the explicit backward
    (`rmsnorm_bwd_ref`, what the CUDA backward computes) and for torch
    autograd through the CPU path."""
    shape = (3, 32, 8, 32) if batched else (32, 8, 32)
    x, s, dy = _inputs(shape, groups=shape[:1] if batched else (), seed=11)

    def f(a, b):
        return r_ops(a, b, EPS)
    if batched:
        f = jax.vmap(f)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(s))
    rdx, rds = (np.asarray(g) for g in vjp(jnp.asarray(dy)))

    tx, ts, tdy = torch.tensor(x), torch.tensor(s), torch.tensor(dy)
    _, rstd = rmsnorm_fwd_ref(tx, ts, EPS)
    dx, ds = rmsnorm_bwd_ref(tx, ts, rstd, tdy)
    wdx, wds = TK.rmsnorm_bwd(tx, ts, rstd, tdy)  # CPU -> plain version
    np.testing.assert_array_equal(wdx.numpy(), dx.numpy())
    np.testing.assert_array_equal(wds.numpy(), ds.numpy())
    lx, ls = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    adx, ads = torch.autograd.grad(t_ops(lx, ls, EPS), (lx, ls), tdy)
    # float32 sums over the row (dx) or over up to 256 rows (dscale) in
    # another order: up to 2e-5 observed on dscale (magnitudes up to ~46),
    # 1.5e-6 on dx
    for got in ((dx, ds), (adx, ads)):
        np.testing.assert_allclose(got[0].numpy(), rdx, rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), rds, rtol=1e-5,
                                   atol=2e-5)


def test_plain_forward_is_the_oracle_in_float32():
    """In float32 the kernel's order (scale in float32, then cast) and the
    oracle's (cast, then scale) are one function."""
    x, s, _ = _inputs((6, 64), seed=3)
    got = rmsnorm_ref(torch.tensor(x), torch.tensor(s), EPS).numpy()
    np.testing.assert_allclose(got, np.asarray(r_ref(jnp.asarray(x),
                                                     jnp.asarray(s), EPS)),
                               rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, s = torch.ones(4, 8, 16), torch.ones(16)
    with pytest.raises(ValueError, match="shape mismatch"):
        TK.rmsnorm(x, torch.ones(8))
    with pytest.raises(ValueError, match="shape mismatch"):
        TK.rmsnorm(x, torch.ones(3, 16))          # 3 scale rows, 4 groups
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TK.rmsnorm(x.double(), s)
    with pytest.raises(ValueError, match="contiguous"):
        TK.rmsnorm(x.transpose(0, 1), s)
    with pytest.raises(ValueError, match="non-empty"):
        TK.rmsnorm(torch.ones(0, 16), s)
    y, rstd = TK.rmsnorm(x, s)
    with pytest.raises(ValueError, match="rstd"):
        TK.rmsnorm_bwd(x, s, rstd[:-1], x)
    with pytest.raises(ValueError, match="dy must match"):
        TK.rmsnorm_bwd(x, s, rstd, x[:2])


@pytest.mark.parametrize("d, dtype, offsets, wide", [
    (32, torch.float32, (0, 0), 4),       # the path's rows: 128 bytes
    (4096, torch.bfloat16, (0, 0), 8),    # a zoo width
    (36, torch.float32, (0, 0), 4),       # 144 bytes: whole 16-byte loads
    (36, torch.bfloat16, (0, 0), 1),      # 72 bytes: the 1-wide path
    (256, torch.float32, (1, 0), 1),      # x one element into its buffer
    (256, torch.bfloat16, (0, 3), 1),     # scale three elements in
    (256, torch.bfloat16, (4, 8), 8),     # offsets of 8 and 16 bytes
])
def test_vector_width_follows_width_dtype_and_alignment(d, dtype, offsets,
                                                        wide):
    """The wrapper's choice between the 16-byte and the 1-wide kernels,
    from the row's width in bytes and the pointers' alignment (CPU
    tensors viewed at element offsets into their buffers)."""
    x_off, s_off = offsets
    x = torch.empty(3 * d + 16, dtype=dtype)[x_off:x_off + 3 * d]
    s = torch.empty(d + 16, dtype=dtype)[s_off:s_off + d]
    assert x.is_contiguous() and s.is_contiguous()
    got = TK.vector_width(d, x.element_size(), x.data_ptr(), s.data_ptr())
    if x_off * x.element_size() % 16 == 0 and \
            s_off * s.element_size() % 16 == 0:
        assert got == wide
    else:
        assert got == 1
    meta = torch.empty(3, d, dtype=dtype, device="meta")
    assert TK.vector_width(d, meta.element_size(), meta.data_ptr()) == \
        (1 if (d * meta.element_size()) % 16 else 16 // meta.element_size())


@pytest.mark.parametrize("chunks, wide, loads, want", [
    (8, True, 2, (3, 1)),          # D = 32 f32: 8 lanes, 4 rows a warp
    (512, True, 16, (5, 16)),      # D = 4096 bf16: a warp per row
    (512, True, 4, (7, 4)),        # 4 warps per row
    (512, True, 2, (8, 2)),        # the wrapper's choice: 8 warps per row
    (36, False, 2, (5, 2)),        # D = 36 bf16, 1-wide
    (9, True, 2, (4, 1)),          # 9 loads: 16 lanes, 7 idle
    (1, False, 2, (0, 1)),
    (2048, True, 2, (8, 8)),       # the widest 16-byte row
    (4096, False, 2, (8, 16)),     # the widest 1-wide row
])
def test_layout_covers_the_row(chunks, wide, loads, want):
    tpr_log2, nl = TK.layout(chunks, wide, loads)
    assert (tpr_log2, nl) == want
    assert (1 << tpr_log2) * nl >= chunks and nl in (1, 2, 4, 8, 16)
    assert (1 << tpr_log2) <= TK.THREADS


@pytest.mark.parametrize("chunks, wide", [(2049, True), (4097, False)])
def test_layout_rejects_rows_wider_than_the_registers_hold(chunks, wide):
    """A row one access wider than the register-held kernels take goes to
    the row-looping kernels (ROADMAP C10), at either load budget; one
    access narrower stays register-held."""
    for loads in (TK.FWD_LOADS, TK.BWD_LOADS, 16):
        assert TK.layout(chunks, wide, loads) == TK.LOOP == (8, 0)
        assert TK.layout(chunks - 1, wide, loads)[1] > 0


@pytest.mark.parametrize("d, dtype, x_off, want", [
    (20_000, torch.float32, 0, 4),     # 5,000 16-byte loads
    (32_768, torch.bfloat16, 0, 8),    # 4,096 16-byte loads
    (4_100, torch.float32, 1, 1),      # x one element in: 4,100 1-wide
])
def test_wide_rows_take_the_looping_layout(d, dtype, x_off, want):
    """The three widths of ROADMAP C10 the card checks: the wrapper picks
    the vector width as before and the row-looping layout, and the
    backward gets a workspace for its column sums."""
    x = torch.empty(2 * d + 8, dtype=dtype)[x_off:x_off + 2 * d]
    vec = TK.vector_width(d, x.element_size(), x.data_ptr())
    assert vec == want
    assert TK.layout(d // vec, vec > 1, TK.FWD_LOADS) == TK.LOOP
    rows, per_group = TK.tiles(1, 2, TK.LOOP[0])
    assert (rows, per_group) == (2, 1)


def test_wide_rows_match_oracle_and_vjp():
    """ROADMAP C10 on the CPU: D = 20,000 float32 (wider than the
    register-held kernels take), forward against the reference's oracle
    and its Pallas kernel in interpret mode, gradients against `jax.vjp`
    of the ops dispatch."""
    x, s, dy = _inputs((3, 20_000), seed=20)
    jx, js = jnp.asarray(x), jnp.asarray(s)
    tx, ts, tdy = torch.tensor(x), torch.tensor(s), torch.tensor(dy)
    y, rstd = TK.rmsnorm(tx, ts, EPS)
    np.testing.assert_allclose(y.numpy(), np.asarray(r_ref(jx, js, EPS)),
                               **F32)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(r_pallas(jx, js, EPS, rows=8,
                                       interpret=True)), **F32)
    _, vjp = jax.vjp(lambda a, b: r_ops(a, b, EPS), jx, js)
    rdx, rds = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    dx, ds = TK.rmsnorm_bwd(tx, ts, rstd, tdy)
    np.testing.assert_allclose(dx.numpy(), rdx, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(ds.numpy(), rds, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("g, r, tpr_log2, want", [
    (20, 256, 3, (256, 1)),       # the path: a group is one tile
    (1, 16384, 8, (63, 261)),     # the zoo backward: 261 tiles
    (8, 1000, 7, (32, 32)),       # rows no multiple of the tile
    (1, 8000, 3, (512, 16)),      # tiles of 16 steps of 32 rows
    (2, 100, 7, (26, 4)),         # an odd tile: 13 steps of 2 rows
    (300, 7, 3, (32, 1)),
    (1, 1, 8, (1, 1)),
])
def test_backward_tiles_cover_each_group_once(g, r, tpr_log2, want):
    rows, per_group = TK.tiles(g, r, tpr_log2)
    assert (rows, per_group) == want
    rpb = TK.THREADS >> tpr_log2
    assert rows % rpb == 0 and (per_group - 1) * rows < r <= per_group * rows
    assert g * per_group <= max(TK.TILES, g) + g
    capped = -(-r // (rpb * TK.TILE_STEPS)) > -(-TK.TILES // g)
    assert rows <= rpb * TK.TILE_STEPS or capped


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the wrapper down
    its kernel path on a machine that has no card."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda(*tensors):
    return [torch.Tensor._make_subclass(_CudaLabelled, t) for t in tensors]


def test_wrapper_checks_cuda_inputs_before_the_kernel():
    """On the kernel's path (CUDA tensors) the wrapper raises what it
    raises on the CPU, before it builds or launches anything; inputs it
    takes reach the kernel, which cannot be built here."""
    x, s = torch.ones(4, 8, 16), torch.ones(16)
    rstd = torch.ones(32)
    bad = [
        (ValueError, "shape mismatch", lambda: TK.rmsnorm(
            *_cuda(x, torch.ones(8)))),
        (ValueError, "shape mismatch", lambda: TK.rmsnorm(
            *_cuda(x, torch.ones(3, 16)))),
        (TypeError, "float32 or bfloat16", lambda: TK.rmsnorm(
            *_cuda(x.double(), s))),
        (ValueError, "contiguous", lambda: TK.rmsnorm(
            *_cuda(x.transpose(0, 1), s))),
        (ValueError, "non-empty", lambda: TK.rmsnorm(
            *_cuda(torch.ones(0, 16), s))),
        (ValueError, "different devices", lambda: TK.rmsnorm(
            _cuda(x)[0], s)),
        (ValueError, "rstd", lambda: TK.rmsnorm_bwd(
            *_cuda(x, s, rstd[:-1], x))),
        (ValueError, "dy must match", lambda: TK.rmsnorm_bwd(
            *_cuda(x, s, rstd, x[:2]))),
        (ValueError, "different devices", lambda: TK.rmsnorm_bwd(
            *_cuda(x, s), rstd, _cuda(x)[0])),
        (ValueError, "contiguous", lambda: TK.rmsnorm_bwd(
            *_cuda(x, s, torch.ones(64)[::2], x))),
    ]
    for exc, match, call in bad:
        with pytest.raises(exc, match=match):
            call()
    for call in (lambda: TK.rmsnorm(*_cuda(x, s)),
                 lambda: TK.rmsnorm_bwd(*_cuda(x, s, rstd, x))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
