"""The port's flash attention (`repro_torch.kernels.flash_attention`: the
plain version the wrapper sends CPU tensors to, the explicit backward the
CUDA kernels compute, and the autograd function of `ops`) against
`repro.kernels.flash_attention`: the jnp oracle `attention_ref`, the
Pallas kernel in interpret mode (as tests/test_kernels.py runs it on the
CPU), `jax.vjp` of the oracle (what the reference's client update
differentiates off the TPU) and the reference's `flash_attention_bshd`.
Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as r_pallas
from repro.kernels.flash_attention.ops import flash_attention_bshd as r_bshd
from repro.kernels.flash_attention.ref import attention_ref as r_ref
from repro_torch.kernels import build as TB
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import kernel as TK
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bshd)
from repro_torch.kernels.flash_attention.ref import (_grouped, _mask,
                                                     attention_bwd_ref,
                                                     attention_fwd_ref)

# float32: the same float32 arithmetic in another order (the tolerance of
# tests/test_kernels.py's attention sweeps)
F32 = dict(rtol=0, atol=2e-5)
# bfloat16: inputs rounded alike, float32 inside, one rounding of the
# output that may go the other way (test_kernels.py's bfloat16 tolerance)
BF16 = dict(rtol=3e-2, atol=3e-2)
# gradients in float32: sums over up to G x 128 rows in another order;
# up to 6e-6 observed against magnitudes up to ~14
GRAD = dict(rtol=1e-5, atol=2e-5)

GQA_MASK = [(h, k, causal, window) for h, k in [(4, 4), (4, 2), (8, 1)]
            for causal, window in [(True, 0), (True, 32), (False, 0)]]
FL_SHAPE = (32, 4, 2, 8, 8)          # B, H, K, S, hd of the payload


def _qkvd(B, H, K, sq, sk, hd, seed, dtype="float32"):
    r = np.random.default_rng(seed)
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((B, H, sq, hd), (B, K, sk, hd), (B, K, sk, hd),
                        (B, H, sq, hd))]
    jax_in = [jnp.asarray(a, dtype) for a in arrays]
    torch_in = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_in, torch_in


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _forward_checks(jin, tin, tol, *, causal, window, bq, bk):
    q, k, v, _ = tin
    o = flash_attention(q, k, v, causal=causal, window=window)
    o_wrap, lse = TK.flash_attention(q, k, v, causal=causal, window=window)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    np.testing.assert_array_equal(_np(o_wrap), _np(o))
    oracle = r_ref(*jin[:3], causal=causal, window=window)
    pallas = r_pallas(*jin[:3], causal=causal, window=window, bq=bq, bk=bk,
                      interpret=True)
    np.testing.assert_allclose(_np(o), _np(oracle), **tol)
    np.testing.assert_allclose(_np(o), _np(pallas), **tol)


@pytest.mark.parametrize("h,k,causal,window", GQA_MASK)
def test_forward_gqa_mask_sweep(h, k, causal, window):
    """tests/test_kernels.py's GQA x mask sweep (B=2, S=128, hd=64)."""
    jin, tin = _qkvd(2, h, k, 128, 128, 64, seed=h * 10 + k + window)
    _forward_checks(jin, tin, F32, causal=causal, window=window, bq=32,
                    bk=32)


@pytest.mark.parametrize("sq,sk", [(64, 64), (100, 200), (64, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_shape_dtype_sweep(sq, sk, dtype):
    """tests/test_kernels.py's Sq/Sk x dtype sweep (unmasked, hd=128)."""
    jin, tin = _qkvd(1, 2, 2, sq, sk, 128, seed=sq + sk, dtype=dtype)
    _forward_checks(jin, tin, F32 if dtype == "float32" else BF16,
                    causal=False, window=0, bq=32, bk=64)


def test_forward_fl_shape():
    """The payload's attention: B=32 samples, H=4 over K=2, S=8, hd=8."""
    B, H, K, S, hd = FL_SHAPE
    jin, tin = _qkvd(B, H, K, S, S, hd, seed=5)
    _forward_checks(jin, tin, F32, causal=True, window=0, bq=S, bk=S)


@pytest.mark.parametrize("case", ["fl"] + [f"{h}-{k}-{c}-{w}" for h, k, c, w
                                           in GQA_MASK])
def test_gradients_match_jax_vjp(case):
    """dq, dk and dv for a random cotangent, against `jax.vjp` of the
    oracle, at the payload's shape and over the GQA x mask sweep. Checked
    for the explicit FlashAttention-2 backward (`attention_bwd_ref`, what
    the CUDA backward computes, fed the forward's o and log-sum-exp) and
    for torch autograd through the CPU path."""
    if case == "fl":
        (B, H, K, S, hd), causal, window = FL_SHAPE, True, 0
    else:
        h, k, c, w = case.split("-")
        B, H, K, S, hd = 2, int(h), int(k), 128, 64
        causal, window = c == "True", int(w)
    jin, tin = _qkvd(B, H, K, S, S, hd, seed=sum(map(ord, case)))
    kw = dict(causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: r_ref(a, b, c, **kw), *jin[:3])
    ref = [np.asarray(g) for g in vjp(jin[3])]

    q, k_, v, do = tin
    o, lse = attention_fwd_ref(q, k_, v, **kw)
    explicit = attention_bwd_ref(q, k_, v, o, lse, do, **kw)
    wrapped = TK.flash_attention_bwd(q, k_, v, o, lse, do, **kw)
    for a, b in zip(explicit, wrapped):          # CPU -> plain version
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    leaves = [t.clone().requires_grad_() for t in (q, k_, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    for got in (explicit, auto):
        for name, g, r in zip("qkv", got, ref):
            np.testing.assert_allclose(g.numpy(), r, err_msg="d" + name,
                                       **GRAD)


@pytest.mark.parametrize("B,S,H,K,hd", [(4, 8, 4, 2, 8), (2, 16, 8, 1, 16)])
def test_bshd_layout_matches_reference(B, S, H, K, hd):
    """The transformer's (B, S, H, hd) entry point against the
    reference's, which off the TPU is the oracle."""
    r = np.random.default_rng(B * S)
    q = r.standard_normal((B, S, H, hd)).astype(np.float32)
    k = r.standard_normal((B, S, K, hd)).astype(np.float32)
    v = r.standard_normal((B, S, K, hd)).astype(np.float32)
    ref = r_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=True)
    got = flash_attention_bshd(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=True)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_fully_masked_rows_give_zero():
    """With a window and Sq > Sk some query rows see no key. The port
    follows the TPU kernel there (output 0, gradient 0); the oracle gives
    the mean of v (ROADMAP C3), so only the other rows are compared."""
    B, H, K, sq, sk, hd, window = 1, 2, 1, 16, 4, 8, 2
    jin, tin = _qkvd(B, H, K, sq, sk, hd, seed=9)
    q, k, v, do = tin
    dead = np.arange(sq) >= sk + window - 1      # rows with no key
    assert dead.any() and not dead.all()
    o = flash_attention(q, k, v, causal=True, window=window)
    oracle = np.asarray(r_ref(*jin[:3], causal=True, window=window))
    assert not np.any(_np(o)[:, :, dead])
    np.testing.assert_allclose(_np(o)[:, :, ~dead], oracle[:, :, ~dead],
                               **F32)
    o2, lse = attention_fwd_ref(q, k, v, causal=True, window=window)
    assert np.all(np.isneginf(lse.numpy()[:, :, dead]))
    dq, dk, dv = attention_bwd_ref(q, k, v, o2, lse, do, causal=True,
                                   window=window)
    assert not np.any(dq.numpy()[:, :, dead])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        flash_attention(*leaves, causal=True, window=window), leaves, do)
    assert not np.any(auto[0].numpy()[:, :, dead])
    for a, b in zip((dq, dk, dv), auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


class _CudaLabelled(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes the wrapper down
    its kernel path on a machine that has no card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Every head dim runs on the CPU (hd 12 gives the reference's
    result); on the card's path hd 257 passes the head-dim check (it is
    padded to 512 and stops only where the kernel would be built), and a
    head dim above the kernels' limit raises, naming the limit, before
    anything is built."""
    q, k = torch.ones(1, 4, 8, 8), torch.ones(1, 2, 8, 8)
    jin, tin = _qkvd(1, 4, 2, 8, 8, 12, seed=12)
    o, lse = TK.flash_attention(*tin[:3])
    np.testing.assert_allclose(_np(o), _np(r_ref(*jin[:3])), **F32)

    def fake(hd):
        return [torch.Tensor._make_subclass(_CudaLabelled, t) for t in (
            torch.ones(1, 4, 8, hd), torch.ones(1, 2, 8, hd),
            torch.ones(1, 2, 8, hd))]
    with pytest.raises(RuntimeError, match="CUDA device"):
        TK.flash_attention(*fake(257))
    with pytest.raises(ValueError, match=f"limit of {TK.MAX_HEAD_DIM}"):
        TK.flash_attention(*fake(TK.MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError, match="multiple of K"):
        TK.flash_attention(q, torch.ones(1, 3, 8, 8), torch.ones(1, 3, 8, 8))
    with pytest.raises(TypeError, match="one dtype"):
        TK.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="contiguous"):
        TK.flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="non-empty"):
        TK.flash_attention(q, k[:, :, :0], k[:, :, :0])
    o, lse = TK.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="lse"):
        TK.flash_attention_bwd(q, k, k, o, lse[..., :-1], o)


# head dims the kernels do not instantiate: zero-padded on the card to 16
# (CUDA cores) and to 128 (the tensor cores in bfloat16)
ODD_HD = [(hd, causal, window) for hd in (12, 80)
          for causal, window in ((True, 0), (True, 3))]
# head dims above 256: padded on the card to 512 (the row-looping kernels)
WIDE_HD = [(257, True, 0), (300, True, 3)]


@pytest.mark.parametrize("hd,causal,window", ODD_HD + WIDE_HD)
def test_odd_head_dims_match_reference(hd, causal, window):
    """ROADMAP C9: the port at head dims 12 and 80 (GQA 4 over 2, causal,
    with and without a window of 3) and above 256 (257; 300 with a window
    of 3), forward against the oracle and the Pallas kernel in interpret
    mode, gradients against `jax.vjp` of the oracle."""
    jin, tin = _qkvd(2, 4, 2, 24, 24, hd, seed=hd + window)
    kw = dict(causal=causal, window=window)
    _forward_checks(jin, tin, F32, bq=8, bk=8, **kw)
    _, vjp = jax.vjp(lambda a, b, c: r_ref(a, b, c, **kw), *jin[:3])
    ref = [np.asarray(g) for g in vjp(jin[3])]
    q, k, v, do = tin
    o, lse = attention_fwd_ref(q, k, v, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    for got in (TK.flash_attention_bwd(q, k, v, o, lse, do, **kw), auto):
        for name, g, r in zip("qkv", got, ref):
            np.testing.assert_allclose(g.numpy(), r, err_msg="d" + name,
                                       **GRAD)


@pytest.mark.parametrize("hd,causal,window", ODD_HD + [
    (1, True, 0), (200, False, 0), (257, True, 0), (520, False, 0)])
def test_zero_padding_the_head_dim_changes_nothing(hd, causal, window):
    """What the wrapper does on the card: q, k, v (and o, do) zero-padded
    along hd to the instantiated width (above 256 a multiple of 256), the
    true hd's scale, the result sliced back. The plain versions on padded
    inputs equal them on the unpadded ones."""
    width = TK.padded_head_dim(hd)
    assert width >= hd
    assert width in TK.HEAD_DIMS if hd <= 256 else (
        width % TK.WIDE_CHUNK == 0 and width - hd < TK.WIDE_CHUNK)
    _, (q, k, v, do) = _qkvd(2, 4, 2, 20, 24, hd, seed=hd)
    kw = dict(causal=causal, window=window)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    grads = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    pq, pk, pv, po, pdo = (TK.pad_head_dim(t, width)
                           for t in (q, k, v, o, do))
    assert pq.shape[-1] == width and pq.is_contiguous()
    assert not pq[..., hd:].any()
    o_p, lse_p = attention_fwd_ref(pq, pk, pv, scale=hd ** -0.5, **kw)
    grads_p = attention_bwd_ref(pq, pk, pv, po, lse_p, pdo,
                                scale=hd ** -0.5, **kw)
    # the same float32 sums; above hd 256 the CPU's BLAS blocks the
    # padded width's longer dot products differently (up to 2.1e-6 read
    # at hd 520, padded to 768)
    tol = dict(rtol=1e-6, atol=1e-6) if hd <= 256 else dict(rtol=1e-5,
                                                             atol=1e-5)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), **tol)
    assert not o_p[..., hd:].any()
    for a, b in zip((o_p,) + grads_p, (o,) + grads):
        np.testing.assert_allclose(a[..., :hd].numpy(), b.numpy(), **tol)
    assert TK.pad_head_dim(q, hd) is q


def test_route_and_padding_for_every_head_dim():
    """`route` for every (dtype, hd) pair up to 1,024: bfloat16 at padded
    hd 64 or 128 goes to the tensor cores, everything else (float32 at any
    hd, bfloat16 at padded 8-32, 256 or above) to the CUDA cores; above
    256 the width is the next multiple of 256; the limit is the widest such
    width, and one more raises, naming it."""
    for hd in range(1, 1025):
        width = TK.padded_head_dim(hd)
        if hd <= 256:
            assert width == min(w for w in TK.HEAD_DIMS if w >= hd)
        else:
            assert width == -(-hd // 256) * 256, hd
        assert TK.route(torch.float32, width) == "cuda_core"
        want = "tc" if 33 <= hd <= 128 else "cuda_core"
        assert TK.route(torch.bfloat16, width) == want, hd
    # the widest padded width whose float32 dk and dv rows (8 bytes a dim)
    # fit one block's 227 KB of shared memory
    assert TK.MAX_HEAD_DIM == 28_928 >= 4_096
    assert 8 * TK.MAX_HEAD_DIM <= 232_448 < 8 * (TK.MAX_HEAD_DIM + 256)
    assert TK.padded_head_dim(TK.MAX_HEAD_DIM) == TK.MAX_HEAD_DIM
    with pytest.raises(ValueError, match="limit of 28928"):
        TK.padded_head_dim(TK.MAX_HEAD_DIM + 1)


class _Library(Exception):
    """Raised by a stand-in for a kernel library: which one was asked."""


@pytest.mark.parametrize("dtype,hd,want", [
    ("bfloat16", 64, "tc"), ("bfloat16", 80, "tc"), ("bfloat16", 128, "tc"),
    ("bfloat16", 32, "cuda_core"), ("bfloat16", 256, "cuda_core"),
    ("bfloat16", 300, "cuda_core"), ("float32", 64, "cuda_core"),
    ("float32", 1000, "cuda_core")])
def test_both_directions_take_the_route(monkeypatch, dtype, hd, want):
    """On a CUDA tensor the forward and the backward each ask for the
    library `route` names (tensor cores: `flash_fwd_tc.cu` and
    `flash_bwd_tc.cu`; CUDA cores: `flash_attention.cu`) before anything
    is allocated or counted."""
    def ask(name):
        def library():
            raise _Library(name)
        return library
    monkeypatch.setattr(TK, "_library", ask("cuda_core"))
    monkeypatch.setattr(TK, "_library_tc", ask("tc"))
    monkeypatch.setattr(TK, "_library_bwd_tc", ask("tc"))
    dt = getattr(torch, dtype)
    assert TK.route(dt, TK.padded_head_dim(hd)) == want
    q, k = torch.ones(1, 4, 8, hd, dtype=dt), torch.ones(1, 2, 8, hd, dtype=dt)
    lse = torch.zeros(1, 4, 8)
    before = dict(launch_counts)
    for call in (lambda *t: TK.flash_attention(*t[:3]),
                 TK.flash_attention_bwd):
        fake = [torch.Tensor._make_subclass(_CudaLabelled, t)
                for t in (q, k, k, q, lse, q)]
        with pytest.raises(_Library) as asked:
            call(*fake)
        assert str(asked.value) == want
    assert dict(launch_counts) == before


def _tc_bwd_emulated(q, k, v, o, lse, do, *, causal, window, parts):
    """The tensor-core backward's arithmetic in plain PyTorch: products of
    bf16 inputs summed in float32; P and dS rounded to bf16 as the operands
    of dV, dK and dQ, in one part or split into a high and a low part
    (`split_bf16`); outputs rounded to bf16 once."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    qg, dog = _grouped(q, K), _grouped(do, K)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf)
    mask = _mask(Sq, Sk, causal, window, q.device)
    lse_g = lse.reshape(B, K, H // K, Sq, 1)
    p = torch.where(mask, torch.exp(s * scale - lse_g), 0.0)
    delta = (dog * _grouped(o, K)).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", dog, vf) - delta)

    def operand(x):
        hi = x.bfloat16().float()
        return hi if parts == 1 else hi + (x - hi).bfloat16().float()
    p, ds = operand(p), operand(ds)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, dog)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg) * scale
    return (dq.reshape(B, H, Sq, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


# the card's tolerance of a bfloat16 gradient against the plain backward
# (chip_smoke.py::_tol)
CARD_BF16 = dict(rtol=1e-2, atol=1e-2)
TC_BWD_CASES = [(2, h, k, 128, 128, 64, causal, window)
                for h, k, causal, window in GQA_MASK] + [
    (1, 2, 2, 100, 200, 128, False, 0)]


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("B,H,K,sq,sk,hd,causal,window", TC_BWD_CASES)
def test_tc_backward_roundings_match_jax_vjp(B, H, K, sq, sk, hd, causal,
                                             window, parts):
    """The tensor-core backward's roundings (P and dS as bf16 operands, one
    part or split), emulated, against `jax.vjp` of the oracle at the
    bfloat16 tolerance, over the GQA x mask sweep at hd 64 and at Sq 100 /
    Sk 200, hd 128. The number of parts the wrapper uses also keeps the
    emulation inside the card's tolerance of the plain backward: one part
    leaves it (1.1x the tolerance at GQA 8 over 1, causal)."""
    jin, tin = _qkvd(B, H, K, sq, sk, hd, seed=H * 10 + K + window + hd,
                     dtype="bfloat16")
    kw = dict(causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: r_ref(a, b, c, **kw), *jin[:3])
    ref = [_np(g) for g in vjp(jin[3])]
    q, k, v, do = tin
    o, lse = attention_fwd_ref(q, k, v, **kw)
    got = _tc_bwd_emulated(q, k, v, o, lse, do, parts=parts, **kw)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(_np(g), r, err_msg="d" + name, **BF16)
    if parts == TK.BWD_TC_PARTS:
        for g, r in zip(got, attention_bwd_ref(q, k, v, o, lse, do, **kw)):
            np.testing.assert_allclose(_np(g), _np(r), **CARD_BF16)


def test_build_target_follows_the_headers(tmp_path):
    """A library's name is keyed by its source and every `.cuh` header
    beside it, so an edited header (which a source includes) rebuilds."""
    src = tmp_path / "kernel.cu"
    src.write_text('#include "tiles.cuh"\n')
    header = tmp_path / "tiles.cuh"
    header.write_text("// v1\n")
    first = TB._target(src)
    assert TB._target(src) == first
    header.write_text("// v2\n")
    second = TB._target(src)
    assert second != first and second.parent == TB.BUILD_DIR
    (tmp_path / "other.cuh").write_text("// new\n")
    assert TB._target(src) not in (first, second)
    (tmp_path / "notes.txt").write_text("not a header\n")
    third = TB._target(src)
    (tmp_path / "notes.txt").write_text("edited\n")
    assert TB._target(src) == third
