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
from repro_torch.kernels.flash_attention import kernel as TK
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bshd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
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
    result); on the card's path a head dim above the kernels' 256 raises,
    naming the limit, before anything is built."""
    q, k = torch.ones(1, 4, 8, 8), torch.ones(1, 2, 8, 8)
    jin, tin = _qkvd(1, 4, 2, 8, 8, 12, seed=12)
    o, lse = TK.flash_attention(*tin[:3])
    np.testing.assert_allclose(_np(o), _np(r_ref(*jin[:3])), **F32)
    wide = [torch.Tensor._make_subclass(_CudaLabelled, t) for t in (
        torch.ones(1, 4, 8, 257), torch.ones(1, 2, 8, 257),
        torch.ones(1, 2, 8, 257))]
    with pytest.raises(ValueError, match="limit of 256"):
        TK.flash_attention(*wide)
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


@pytest.mark.parametrize("hd,causal,window", ODD_HD)
def test_odd_head_dims_match_reference(hd, causal, window):
    """ROADMAP C9: the port at head dims 12 and 80 (GQA 4 over 2, causal,
    with and without a window of 3), forward against the oracle and the
    Pallas kernel in interpret mode, gradients against `jax.vjp` of the
    oracle."""
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


@pytest.mark.parametrize("hd,causal,window", ODD_HD + [(1, True, 0),
                                                      (200, False, 0)])
def test_zero_padding_the_head_dim_changes_nothing(hd, causal, window):
    """What the wrapper does on the card: q, k, v (and o, do) zero-padded
    along hd to the instantiated width, the true hd's scale, the result
    sliced back. The plain versions on padded inputs equal them on the
    unpadded ones."""
    width = TK.padded_head_dim(hd)
    assert width in TK.HEAD_DIMS and width >= hd
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
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), **tol)
    assert not o_p[..., hd:].any()
    for a, b in zip((o_p,) + grads_p, (o,) + grads):
        np.testing.assert_allclose(a[..., :hd].numpy(), b.numpy(), **tol)
    assert TK.pad_head_dim(q, hd) is q


def test_route_and_padding_for_every_head_dim():
    """`route` for every (dtype, hd) pair the wrapper takes: bfloat16 at
    padded hd 64 or 128 goes to the tensor cores, everything else (float32
    at any hd, bfloat16 at padded 8-32 or 256) to the CUDA cores; above
    256 nothing."""
    for hd in range(1, TK.MAX_HEAD_DIM + 1):
        width = TK.padded_head_dim(hd)
        assert width == min(w for w in TK.HEAD_DIMS if w >= hd)
        assert TK.route(torch.float32, width) == "cuda_core"
        want = "tc" if 33 <= hd <= 128 else "cuda_core"
        assert TK.route(torch.bfloat16, width) == want, hd
    with pytest.raises(ValueError, match="limit of 256"):
        TK.padded_head_dim(TK.MAX_HEAD_DIM + 1)
