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

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

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


@pytest.mark.parametrize("dtype,hd,want,fwd_want", [
    ("bfloat16", 64, "tc", "tc"), ("bfloat16", 80, "tc", "tc"),
    ("bfloat16", 128, "tc", "tc"), ("bfloat16", 32, "cuda_core", "cuda_core"),
    ("bfloat16", 256, "cuda_core", "tc256"),
    ("bfloat16", 240, "cuda_core", "tc256"),
    ("bfloat16", 300, "cuda_core", "cuda_core"),
    ("float32", 64, "cuda_core", "cuda_core"),
    ("float32", 256, "cuda_core", "cuda_core"),
    ("float32", 1000, "cuda_core", "cuda_core")])
def test_both_directions_take_the_route(monkeypatch, dtype, hd, want,
                                        fwd_want):
    """On a CUDA tensor the forward and the backward each ask for the
    library their route names (tensor cores: `flash_fwd_tc.cu` and
    `flash_bwd_tc.cu`; CUDA cores: `flash_attention.cu`; a bf16 call at
    padded hd 256 that misses the short route: `flash_fwd_tc256.cu` and
    `flash_bwd_tc256.cu`) before anything is counted."""
    def ask(name):
        def library():
            raise _Library(name)
        return library
    monkeypatch.setattr(TK, "_library", ask("cuda_core"))
    monkeypatch.setattr(TK, "_library_tc", ask("tc"))
    monkeypatch.setattr(TK, "_library_bwd_tc", ask("tc"))
    monkeypatch.setattr(TK, "_library_tc256", ask("tc256"))
    monkeypatch.setattr(TK, "_library_bwd_tc256", ask("tc256"))
    dt = getattr(torch, dtype)
    width = TK.padded_head_dim(hd)
    assert TK.route(dt, width) == want
    # the short kernels are in the CUDA cores' library
    fwd_route = TK.forward_route(2, 8, 8, width, dt)
    assert {"short": "cuda_core"}.get(fwd_route, fwd_route) == fwd_want
    assert TK.backward_route(2, 8, 8, width, dt) == fwd_route
    q, k = torch.ones(1, 4, 8, hd, dtype=dt), torch.ones(1, 2, 8, hd, dtype=dt)
    lse = torch.zeros(1, 4, 8)
    before = dict(launch_counts)
    for call, name in ((lambda *t: TK.flash_attention(*t[:3]), fwd_want),
                       (TK.flash_attention_bwd, fwd_want)):
        fake = [torch.Tensor._make_subclass(_CudaLabelled, t)
                for t in (q, k, k, q, lse, q)]
        with pytest.raises(_Library) as asked:
            call(*fake)
        assert str(asked.value) == name
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


# ---------------------------------------------------------------------------
# the short-sequence route (one warp a (b, kv head) unit, the backward in
# one launch, the (B, S, H, hd) layout read in place)

PATH_CALLS = [(640, 4, 2, 8, 8), (1000, 4, 2, 8, 8)]   # training, evaluation


def _working_set(G, Sq, Sk, hd):
    """Bytes, in float32, of one unit's backward working set, term by term:
    q, o and do of G heads; k and v; lse and delta; P and dS."""
    rows = G * Sq
    terms = {"q": rows * hd, "o": rows * hd, "do": rows * hd, "k": Sk * hd,
             "v": Sk * hd, "lse": rows, "delta": rows, "P": rows * Sk,
             "dS": rows * Sk}
    return 4 * sum(terms.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_short_fits_against_the_budget(dtype, G):
    """`short_fits` over (Sq, Sk, padded hd) for G query heads a kv head:
    True exactly where the call is on the CUDA cores at a padded hd of at
    most 256 and the unit's working set is within `SHORT_BUDGET`, the
    budget the CUDA source states. The path's training and evaluation
    calls take it; S = 128, the zoo shape and the tensor-core route do
    not; `route` keeps its answers for every hd up to 1,024."""
    dt = getattr(torch, dtype)
    src = TK.SOURCE.read_text()
    assert f"constexpr int kShortBudget = {TK.SHORT_BUDGET};" in src
    for Sq in (1, 8, 24, 32, 64, 128, 512):
        for Sk in (1, 8, 24, 32, 64, 128, 512):
            for width in TK.HEAD_DIMS + (512, 1024):
                want = (TK.route(dt, width) == "cuda_core" and width <= 256
                        and _working_set(G, Sq, Sk, width)
                        <= TK.SHORT_BUDGET)
                assert TK.short_fits(G, Sq, Sk, width, dt) == want, (
                    Sq, Sk, width)
                if Sq == Sk == 128:
                    assert not want
    for B, H, K, S, hd in PATH_CALLS:
        assert TK.short_fits(H // K, S, S, TK.padded_head_dim(hd),
                             torch.float32)
    # qwen3-8b's heads at S = 2048 (bf16 at hd 128: the tensor cores)
    assert not TK.short_fits(4, 2048, 2048, 128, torch.bfloat16)
    assert not TK.short_fits(4, 2048, 2048, 128, torch.float32)
    for width in TK.TC_HEAD_DIMS:
        assert TK.route(torch.bfloat16, width) == "tc"
        assert not TK.short_fits(G, 8, 8, width, torch.bfloat16)
    for hd in range(1, 1025):
        width = TK.padded_head_dim(hd)
        assert TK.route(torch.float32, width) == "cuda_core"
        assert TK.route(torch.bfloat16, width) == (
            "tc" if 33 <= hd <= 128 else "cuda_core")


class _FakeLibrary:
    """A stand-in for `_library()`: four entry points (forward, backward,
    short forward, short backward) that record their arguments and return
    `err`."""

    NAMES = ("fwd", "bwd", "fwd_short", "bwd_short")

    def __init__(self, err=0):
        self.calls = []
        self.err = err

    def __call__(self):
        def entry(name):
            def launch(*args):
                self.calls.append((name, args))
                return self.err
            return launch
        return tuple(entry(n) for n in self.NAMES)


def _projection_views(B, S, H, K, hd, seed=0):
    """q (B, S, H, hd), k and v (B, S, K, hd) as strided views of one fused
    (B, S, H + 2K, hd) projection, labelled CUDA, and the cotangent do
    (B, S, H, hd) as a view of (B, S, H * hd)."""
    r = np.random.default_rng(seed)
    fused = torch.tensor(r.standard_normal((B, S, H + 2 * K, hd)),
                         dtype=torch.float32)
    do = torch.tensor(r.standard_normal((B, S, H * hd)),
                      dtype=torch.float32).view(B, S, H, hd)
    views = (fused[:, :, :H], fused[:, :, H:H + K], fused[:, :, H + K:], do)
    fake = tuple(torch.Tensor._make_subclass(_CudaLabelled, t)
                 for t in views)
    for t, f in zip(views, fake):
        assert f.data_ptr() == t.data_ptr() and f.stride() == t.stride()
    return fake


def _count_allocations(monkeypatch):
    """Counts of tensor allocations and copies made through the functions
    the wrappers use (a call the tensor subclass's dispatch makes inside
    another counts once)."""
    counts, depth = {}, [0]
    for owner, name in ((torch.Tensor, "new_empty"), (torch, "empty_like"),
                        (torch, "empty"), (torch.Tensor, "clone"),
                        (torch.Tensor, "contiguous")):
        original = getattr(owner, name)

        def counted(*a, _name=name, _original=original, **kw):
            if not depth[0]:
                counts[_name] = counts.get(_name, 0) + 1
            depth[0] += 1
            try:
                return _original(*a, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(owner, name, counted)
    return counts


def _bsh(t, bshd=True):
    """The (batch, sequence, head) strides the wrapper passes for t."""
    return [t.stride()[d] for d in ((0, 1, 2) if bshd else (0, 2, 1))]


def _short_call(args):
    """The fields of the one `SHORT_ARGS` block a short entry point was
    given: pointers, sizes (B, H, K, Sq, Sk, hd, causal, window, bf16),
    stream, scale and strides, unused fields included."""
    (block,) = args
    assert isinstance(block, bytes) and len(block) == TK.SHORT_ARGS.size
    f = TK.SHORT_ARGS.unpack(block)
    return {"ptrs": f[:9], "sizes": f[9:18], "stream": f[18],
            "scale": f[19], "strides": list(f[20:])}


def test_short_args_block_matches_the_source():
    """The wrapper packs the short entry points' argument as the CUDA
    source's `ShortArgs` lays it out: 44 fields of 8 bytes, in the order
    of the struct's members."""
    src = TK.SOURCE.read_text()
    body = src[src.index("struct ShortArgs {"):]
    body = body[:body.index("};")]
    members = [line.split("//")[0].strip() for line in body.splitlines()[1:]]
    assert [m for m in members if m] == [
        "uint64_t ptr[9];",
        "int64_t B, H, K, Sq, Sk, hd, causal, window, bf16;",
        "uint64_t stream;", "double scale;", "int64_t st[8][3];"]
    assert "static_assert(sizeof(ShortArgs) == 44 * 8" in src
    assert TK.SHORT_ARGS.format == "<9Q9qQd24q"
    assert TK.SHORT_ARGS.size == 44 * 8


@pytest.mark.parametrize("window", [0, 3])
def test_bshd_views_reach_the_short_kernels_in_place(monkeypatch, window):
    """On a CUDA tensor that fits the short route, the (B, S, H, hd) entry
    points hand the C entry points the projections' own views (their
    `data_ptr()`, no copy) with the strides of that layout; the forward
    allocates o and lse only, the backward dq, dk and dv only (no delta
    workspace); each counts one call on its counter and its `_short`
    counter."""
    B, S, H, K, hd = 3, 8, 4, 2, 8
    q, k, v, do = _projection_views(B, S, H, K, hd)
    fake = _FakeLibrary()
    monkeypatch.setattr(TK, "_library", fake)
    monkeypatch.setattr(TK, "_stream", lambda t: 1234)
    before = dict(launch_counts)
    counts = _count_allocations(monkeypatch)
    o, lse = TK.flash_attention_bshd(q, k, v, causal=True, window=window)
    assert counts == {"empty_like": 1, "new_empty": 1}
    assert o.shape == q.shape and o.is_contiguous()
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    (name, args), = fake.calls
    assert name == "fwd_short"
    call = _short_call(args)
    assert call["ptrs"] == tuple(t.data_ptr() for t in (q, k, v, o, lse)) \
        + (0,) * 4
    assert call["sizes"] == (B, H, K, S, S, hd, 1, window, 0)
    assert (call["stream"], call["scale"]) == (1234, hd ** -0.5)
    assert call["strides"] == sum((_bsh(t) for t in (q, k, v, o)), []) \
        + [0] * 12
    counts.clear()
    grads = TK.flash_attention_bshd_bwd(q, k, v, o, lse, do, causal=True,
                                        window=window)
    assert counts == {"empty_like": 3}
    (name, args), = fake.calls[1:]
    assert name == "bwd_short"
    ins = (q, k, v, o, lse, do)
    call = _short_call(args)
    assert call["ptrs"] == tuple(t.data_ptr() for t in ins + grads)
    assert call["sizes"] == (B, H, K, S, S, hd, 1, window, 0)
    assert (call["stream"], call["scale"]) == (1234, hd ** -0.5)
    assert call["strides"] == sum((_bsh(t) for t in (q, k, v, o, do)
                                   + grads), [])
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.is_contiguous()
    after = dict(launch_counts)
    for name in (TK.NAME, TK.NAME_SHORT, TK.NAME_BWD, TK.NAME_BWD_SHORT):
        assert after.get(name, 0) == before.get(name, 0) + 1
    for name in (TK.NAME_TC, TK.NAME_BWD_TC):
        assert after.get(name, 0) == before.get(name, 0)


def test_bhsd_calls_that_fit_take_the_short_kernels(monkeypatch):
    """The (B, H, S, hd) wrappers send a call that fits to the same short
    entry points, with that layout's strides (batch, sequence, head), and
    allocate only o and lse, then dq, dk and dv."""
    B, H, K, S, hd = 2, 8, 1, 16, 16
    assert TK.short_fits(H // K, S, S, hd, torch.float32)
    q, k = torch.ones(B, H, S, hd), torch.ones(B, K, S, hd)
    q, k, v, do = _fake_cuda_all(q, k, k.clone(), q.clone())
    fake = _FakeLibrary()
    monkeypatch.setattr(TK, "_library", fake)
    monkeypatch.setattr(TK, "_stream", lambda t: 0)
    counts = _count_allocations(monkeypatch)
    o, lse = TK.flash_attention(q, k, v, causal=False, window=0)
    grads = TK.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert counts == {"empty_like": 4, "new_empty": 1}
    (f, fargs), (b, bargs) = fake.calls
    assert (f, b) == ("fwd_short", "bwd_short")
    assert _short_call(fargs)["strides"] == sum(
        (_bsh(t, False) for t in (q, k, v, o)), []) + [0] * 12
    assert _bsh(q, False) == [H * S * hd, hd, S * hd]
    assert _short_call(bargs)["strides"] == sum(
        (_bsh(t, False) for t in (q, k, v, o, do) + grads), [])
    for args in (fargs, bargs):
        assert _short_call(args)["sizes"] == (B, H, K, S, S, hd, 0, 0, 0)


def _fake_cuda_all(*tensors):
    return [torch.Tensor._make_subclass(_CudaLabelled, t) for t in tensors]


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 2, 128, 8), (1, 8, 1, 64, 64)])
def test_calls_that_do_not_fit_take_the_old_entry_points(monkeypatch, bshd,
                                                         shape):
    """A CUDA-labelled call that does not fit the short route (S = 128; a
    unit of 8 heads at S = 64, hd 64) asks for the CUDA-core forward and
    backward, `_library()[0]` and `[1]`, in either layout, and counts no
    `_short` call."""
    B, H, K, S, hd = shape
    assert not TK.short_fits(H // K, S, S, hd, torch.float32)
    if bshd:
        q, k = torch.ones(B, S, H, hd), torch.ones(B, S, K, hd)
        fwd, bwd = TK.flash_attention_bshd, TK.flash_attention_bshd_bwd
    else:
        q, k = torch.ones(B, H, S, hd), torch.ones(B, K, S, hd)
        fwd, bwd = TK.flash_attention, TK.flash_attention_bwd
    q, k, v, do = _fake_cuda_all(q, k, k.clone(), q.clone())
    fake = _FakeLibrary()
    monkeypatch.setattr(TK, "_library", fake)
    monkeypatch.setattr(TK, "_stream", lambda t: 0)
    before = dict(launch_counts)
    o, lse = fwd(q, k, v)
    grads = bwd(q, k, v, o, lse, do)
    assert [c[0] for c in fake.calls] == ["fwd", "bwd"]
    assert o.shape == q.shape and [g.shape for g in grads] == [
        q.shape, k.shape, k.shape]
    after = dict(launch_counts)
    for name in (TK.NAME, TK.NAME_BWD):
        assert after.get(name, 0) == before.get(name, 0) + 1
    for name in (TK.NAME_SHORT, TK.NAME_BWD_SHORT):
        assert after.get(name, 0) == before.get(name, 0)


@pytest.mark.parametrize("bshd", [False, True])
def test_nothing_is_counted_when_the_library_raises(monkeypatch, bshd):
    """A library that cannot be had, or a launch that returns a CUDA
    error, raises and leaves every count as it was."""
    B, S, H, K, hd = 2, 8, 4, 2, 8
    q, k, v, do = _projection_views(B, S, H, K, hd)
    if not bshd:
        q, k, v, do = _fake_cuda_all(*(t.transpose(1, 2).contiguous()
                                       for t in (q, k, v, do)))
    fwd = TK.flash_attention_bshd if bshd else TK.flash_attention
    bwd = TK.flash_attention_bshd_bwd if bshd else TK.flash_attention_bwd
    lse, = _fake_cuda_all(torch.zeros(B, H, S))
    before = dict(launch_counts)

    def missing():
        raise _Library("no library")
    monkeypatch.setattr(TK, "_stream", lambda t: 0)
    monkeypatch.setattr(TK, "_library", missing)
    with pytest.raises(_Library):
        fwd(q, k, v)
    with pytest.raises(_Library):
        bwd(q, k, v, q, lse, do)
    monkeypatch.setattr(TK, "_library", _FakeLibrary(err=700))
    with pytest.raises(RuntimeError, match="flash_fwd_short_launch failed"):
        fwd(q, k, v)
    with pytest.raises(RuntimeError, match="flash_bwd_short_launch failed"):
        bwd(q, k, v, q, lse, do)
    assert dict(launch_counts) == before


BSHD_CASES = ["path"] + [f"{g}-{c}-{w}" for g in (1, 2, 4, 8)
                         for c, w in ((True, 0), (True, 3), (False, 0))]


@pytest.mark.parametrize("case", BSHD_CASES)
def test_bshd_entry_points_match_jax_on_the_cpu(case):
    """On the CPU `ops.flash_attention_bshd` (and the kernel module's
    (B, S, H, hd) entry points, forward and explicit backward) equal the
    reference's `flash_attention_bshd`, which off the TPU is the oracle:
    forward, and gradients against `jax.vjp`, at the transformer path's
    training call (640, 8 tokens, 4 heads over 2, hd 8, causal) and at G
    = 1, 2, 4, 8 query heads a kv head with causal, window 3 and no
    mask."""
    if case == "path":
        (B, H, K, S, hd), causal, window = PATH_CALLS[0], True, 0
    else:
        g, c, w = case.split("-")
        B, K, S, hd, causal, window = 4, 2, 8, 8, c == "True", int(w)
        H = int(g) * K
    r = np.random.default_rng(sum(map(ord, case)))
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd),
                        (B, S, H, hd))]
    kw = dict(causal=causal, window=window)
    jin = [jnp.asarray(a) for a in arrays]
    ref, vjp = jax.vjp(lambda a, b, c: r_bshd(a, b, c, **kw), *jin[:3])
    ref_grads = [np.asarray(x) for x in vjp(jin[3])]
    q, k, v, do = (torch.tensor(a) for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_bshd(*leaves, **kw)
    auto = torch.autograd.grad(o, leaves, do)
    o_k, lse = TK.flash_attention_bshd(q, k, v, **kw)
    explicit = TK.flash_attention_bshd_bwd(q, k, v, o_k, lse, do, **kw)
    assert o.shape == q.shape and lse.shape == (B, H, S)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref), **F32)
    np.testing.assert_array_equal(o_k.numpy(), o.detach().numpy())
    for got in (auto, explicit):
        for name, g, t, want in zip("qkv", got, (q, k, v), ref_grads):
            assert g.shape == t.shape
            np.testing.assert_allclose(g.numpy(), want, err_msg="d" + name,
                                       **GRAD)
