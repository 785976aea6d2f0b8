"""The port's attention backward at (padded) head dim 256 in bfloat16, the
route of `csrc/flash_bwd_tc256.cu` on the card, held on the CPU:

- gradients at hd 256 and 240, float32 and bfloat16, GQA 16 over 1 and 4
  over 1, causal with a window, no mask and Sq != Sk: the port's plain
  backward (what the wrappers give a CPU tensor), torch autograd through
  `ops`, and the tensor-core backward's bf16 roundings emulated, against
  `jax.vjp` of the reference's oracle `attention_ref`; hd 240 zero-padded
  to 256 with the true hd's scale gives the unpadded gradients;
- the split over head groups: `attention_bwd_group_parts_ref` then
  `merge_groups_ref` equal the unsplit plain backward for every group
  count, and `bwd_groups`' choice;
- `backward_route` beside `route`, `forward_route` and `short_fits`, and
  the wrapper's plumbing with a stand-in library: the argument block, the
  strides read in place (no copy in the (B, S, H, hd) entry), the
  workspace, the launch counts, a failed launch raising, and meta calls
  recording `cost.flash`'s backward work.
Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as r_ref
from repro_torch.kernels import cost, launch_counts, meta_counts
from repro_torch.kernels.flash_attention import kernel as TK
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bshd)
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_group_parts_ref, attention_bwd_ref, attention_fwd_ref,
    merge_groups_ref)
from test_torch_flash import _fake_cuda_all as _fake
from test_torch_flash import _tc_bwd_emulated

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# float32 gradients: sums over up to G x S rows in another order (the
# tolerance of tests/test_torch_flash.py's gradients; hd 256 has twice the
# terms a dot product of hd 128 has, under 1e-5 of values up to ~20 here)
GRAD = dict(rtol=1e-5, atol=2e-5)
# bfloat16: inputs rounded alike, float32 inside, one rounding of each
# gradient that may go the other way (test_kernels.py's bfloat16
# tolerance, as tests/test_torch_flash.py's bf16 gradients)
BF16 = dict(rtol=3e-2, atol=3e-2)
# the card's tolerance of a bf16 gradient against the plain backward
# (chip_smoke.py::_tol), which the emulated roundings must keep
CARD_BF16 = dict(rtol=1e-2, atol=1e-2)
# the groups merged against the unsplit plain backward, float32: the same
# products summed in G / groups pieces, then added (up to ~1e-6 read)
MERGE = dict(rtol=1e-6, atol=4e-6)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _qkvd(B, H, K, sq, sk, hd, seed, dtype="float32"):
    r = np.random.default_rng(seed)
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((B, H, sq, hd), (B, K, sk, hd), (B, K, sk, hd),
                        (B, H, sq, hd))]
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays])


# (B, H, K, Sq, Sk, causal, window): GQA 16 over 1 (recurrentgemma-9b's
# layout) causal with a window of 5; 4 over 1 with no mask, Sq < Sk; 4
# over 1 causal with a window of 7, Sq > Sk (no row past Sk + window - 1,
# so every row sees a key: ROADMAP C3)
CASES = [(1, 16, 1, 24, 24, True, 5), (2, 4, 1, 16, 28, False, 0),
         (1, 4, 1, 30, 26, True, 7)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [256, 240])
@pytest.mark.parametrize("B,H,K,sq,sk,causal,window", CASES)
def test_gradients_match_jax_vjp(B, H, K, sq, sk, causal, window, hd,
                                 dtype):
    """dq, dk and dv for a random cotangent against `jax.vjp` of the
    reference's oracle: the plain backward (`attention_bwd_ref` from the
    plain forward's o and lse, which both wrappers give a CPU tensor),
    torch autograd through `ops` in both layouts, and in bfloat16 the
    tensor-core backward's roundings (P and dS in `BWD_TC_PARTS` bf16
    parts), emulated, which also stay within the card's tolerance of the
    plain backward."""
    jin, tin = _qkvd(B, H, K, sq, sk, hd, seed=hd + H + sq + window,
                     dtype=dtype)
    kw = dict(causal=causal, window=window)
    _, vjp = jax.vjp(lambda a, b, c: r_ref(a, b, c, **kw), *jin[:3])
    ref = [_np(g) for g in vjp(jin[3])]
    tol = GRAD if dtype == "float32" else BF16

    q, k, v, do = tin
    o, lse = attention_fwd_ref(q, k, v, **kw)
    plain = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    wrapped = TK.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    bshd = TK.flash_attention_bshd_bwd(
        *(t.transpose(1, 2) for t in (q, k, v, o)), lse, do.transpose(1, 2),
        **kw)
    for a, b, c in zip(plain, wrapped, bshd):
        np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(a), _np(c.transpose(1, 2)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, do)
    views = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    auto_bshd = torch.autograd.grad(flash_attention_bshd(*views, **kw),
                                    views, do.transpose(1, 2))
    got = [plain, auto, [g.transpose(1, 2) for g in auto_bshd]]
    if dtype == "bfloat16":
        emulated = _tc_bwd_emulated(q, k, v, o, lse, do,
                                    parts=TK.BWD_TC_PARTS, **kw)
        for g, r in zip(emulated, plain):
            np.testing.assert_allclose(_np(g), _np(r), **CARD_BF16)
        got.append(emulated)
    for grads in got:
        for name, g, r in zip("qkv", grads, ref):
            assert g.dtype == q.dtype
            np.testing.assert_allclose(_np(g), r, err_msg="d" + name, **tol)


@pytest.mark.parametrize("causal,window", [(True, 5), (False, 0)])
def test_hd_240_padded_to_256_gives_the_unpadded_gradients(causal, window):
    """The card's wrapper zero-pads hd 240 to 256 and passes the true hd's
    scale: the plain backward on the padded inputs (from the padded
    forward), sliced back, equals the unpadded one, and the padded
    columns' gradients are 0."""
    _, (q, k, v, do) = _qkvd(1, 16, 1, 24, 24, 240, seed=240)
    kw = dict(causal=causal, window=window)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    pq, pk, pv, pdo = (TK.pad_head_dim(t, 256) for t in (q, k, v, do))
    po, plse = attention_fwd_ref(pq, pk, pv, scale=240 ** -0.5, **kw)
    np.testing.assert_allclose(_np(plse), _np(lse), **MERGE)
    grads = attention_bwd_ref(pq, pk, pv, po, plse, pdo, scale=240 ** -0.5,
                              **kw)
    for g, w in zip(grads, want):
        assert not g[..., 240:].any()
        np.testing.assert_allclose(_np(g[..., :240]), _np(w), **MERGE)


# ---------------------------------------------------------------------------
# the split over head groups


@pytest.mark.parametrize("B,H,K,sq,sk,causal,window", CASES)
def test_merged_groups_equal_the_unsplit_backward(B, H, K, sq, sk, causal,
                                                  window):
    """For every group count from 1 to G, the heads cut as the kernel cuts
    them and each group's partial dK and dV (dK unscaled) added in order,
    dK then scaled: the unsplit plain backward's dk and dv, float32; one
    group is the unsplit sum itself."""
    _, (q, k, v, do) = _qkvd(B, H, K, sq, sk, 256, seed=sq * sk)
    kw = dict(causal=causal, window=window)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    _, dk, dv = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for groups in range(1, H // K + 1):
        dk_parts, dv_parts = attention_bwd_group_parts_ref(
            q, k, v, o, lse, do, groups, **kw)
        assert dk_parts.shape == (groups, B, K, sk, 256)
        mk, mv = merge_groups_ref(dk_parts, dv_parts, 256 ** -0.5,
                                  torch.float32)
        tol = MERGE if groups > 1 else dict(rtol=0, atol=0)
        np.testing.assert_allclose(_np(mk), _np(dk), **tol)
        np.testing.assert_allclose(_np(mv), _np(dv), **tol)


def test_bwd_groups_fill_the_card():
    """`bwd_groups`: a divisor of G; 1 where the key blocks alone give
    `BWD_WAVES` blocks an SM (gemma3-12b's 8 kv heads at B 2 x S 4096),
    else the fewest groups that do, or G (recurrentgemma-9b's one kv head
    at S 4096: 64 key blocks)."""
    for units in (1, 2, 8, 16):
        for tiles in (1, 8, 64, 256):
            for G in (1, 2, 4, 16):
                for sm in (8, 114, 132):
                    d = TK.bwd_groups(units, tiles, G, sm)
                    blocks = units * tiles
                    assert G % d == 0
                    assert d * blocks >= TK.BWD_WAVES * sm or d == G
                    assert all(e * blocks < TK.BWD_WAVES * sm
                               for e in range(1, d) if G % e == 0)
    assert TK.bwd_groups(16, 64, 2, 132) == 1
    assert TK.bwd_groups(1, 64, 1, 132) == 1
    assert TK.bwd_groups(1, 64, 16, 132) * 64 >= TK.BWD_WAVES * 132 or \
        TK.bwd_groups(1, 64, 16, 132) == 16


# ---------------------------------------------------------------------------
# the route and the wrapper's plumbing


def test_backward_route_beside_route_forward_route_and_short_fits():
    """`backward_route` for every (dtype, hd up to 1,024) and query rows:
    "short" exactly where `short_fits`, "tc256" for the other bfloat16
    calls at padded hd 256, `route`'s answer everywhere else, as
    `forward_route` answers; `route` keeps its answers (tensor cores at
    bf16 64-128)."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in range(1, 1025):
            width = TK.padded_head_dim(hd)
            assert TK.route(dtype, width) == (
                "tc" if dtype == torch.bfloat16 and 33 <= hd <= 128
                else "cuda_core")
            for G, sq, sk in ((1, 1, 1), (2, 1, 576), (16, 16, 2048),
                              (4, 8, 8), (16, 4096, 4096), (1, 17, 9),
                              (2, 4096, 4096)):
                got = TK.backward_route(G, sq, sk, width, dtype)
                assert got == TK.forward_route(G, sq, sk, width, dtype)
                if TK.short_fits(G, sq, sk, width, dtype):
                    assert got == "short"
                elif dtype == torch.bfloat16 and width == 256:
                    assert got == "tc256", (hd, G, sq, sk)
                else:
                    assert got == TK.route(dtype, width)
    # recurrentgemma-9b's train call, gemma3-12b's at hd 240; float32
    # stays on the CUDA cores
    for G, hd in ((16, 256), (2, 240)):
        assert TK.backward_route(G, 4096, 4096, TK.padded_head_dim(hd),
                                 torch.bfloat16) == "tc256"
        assert TK.backward_route(G, 4096, 4096, TK.padded_head_dim(hd),
                                 torch.float32) == "cuda_core"


class _FakeBwd:
    """A stand-in for `_library_bwd_tc256()`: the entry point records its
    argument blocks and returns `err`."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __call__(self):
        def launch(block):
            self.calls.append(TK.TC256_BWD_ARGS.unpack(block))
            return self.err
        return launch


def _fields(f):
    """The `TC256_BWD_ARGS` fields by name."""
    return {"ptrs": f[:11], "sizes": f[11:16], "hd": f[16], "causal": f[17],
            "window": f[18], "groups": f[19], "parts": f[20],
            "stream": f[21], "scale": f[22], "strides": list(f[23:47])}


def _plumbing(monkeypatch, err=0):
    fake = _FakeBwd(err)
    monkeypatch.setattr(TK, "_library_bwd_tc256", fake)
    monkeypatch.setattr(TK, "_stream", lambda t: 77)
    monkeypatch.setattr(TK, "_sm_count", lambda index: 132)
    return fake


def _bsh(t, bshd=True):
    """The (batch, sequence, head) strides the wrapper passes for t, 0
    along a dim of size 1."""
    dims = (0, 1, 2) if bshd else (0, 2, 1)
    return [t.stride(d) if t.shape[d] > 1 else 0 for d in dims]


def _layout(B, H, K, S, hd, bshd):
    """q, k, v, o, do and lse on the card's path (CUDA-labelled): in the
    (B, S, H, hd) layout q, o, do as head views of (B, S, H * hd) and k, v
    as the two halves of one (B, S, 2, K, hd) projection (strided, rows on
    16 bytes); else contiguous (B, H, S, hd)."""
    bf = dict(dtype=torch.bfloat16)
    if bshd:
        q, o, do = (torch.zeros(B, S, H * hd, **bf).view(B, S, H, hd)
                    for _ in range(3))
        kv = torch.zeros(B, S, 2, K, hd, **bf)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        q, o, do = (torch.zeros(B, H, S, hd, **bf) for _ in range(3))
        k, v = (torch.zeros(B, K, S, hd, **bf) for _ in range(2))
    return _fake(q, k, v, o, do, torch.zeros(B, H, S))


@pytest.mark.parametrize("bshd", [False, True])
def test_call_reads_in_place_and_splits_into_groups(monkeypatch, bshd):
    """recurrentgemma-9b's layout cut to S 64 (causal, window 16, 16 query
    heads over 1): one launch; in either layout q, k, v, o and do are
    handed over as they lie, with their strides, and dq, dk, dv come back
    in q's, k's and v's shapes; one key block on a card of 132 SMs splits
    the 16 heads into 16 groups with a (2, 16, B, K, Sk, 256) float32
    workspace; the block carries P and dS's `BWD_TC_PARTS`, the stream and
    the true hd's scale; it counts one `flash_attention_bwd` and one
    `flash_attention_bwd_tc256` launch, and no other."""
    fake = _plumbing(monkeypatch)
    B, H, K, S, hd = 1, 16, 1, 64, 256
    q, k, v, o, do, lse = _layout(B, H, K, S, hd, bshd)
    assert k.is_contiguous() != bshd
    bwd = TK.flash_attention_bshd_bwd if bshd else TK.flash_attention_bwd
    before = dict(launch_counts)
    dq, dk, dv = bwd(q, k, v, o, lse, do, causal=True, window=16)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    (f,) = fake.calls
    args = _fields(f)
    assert args["ptrs"][:6] == tuple(t.data_ptr()
                                     for t in (q, k, v, o, lse, do))
    assert args["ptrs"][6:9] == tuple(t.data_ptr() for t in (dq, dk, dv))
    assert args["strides"] == sum((_bsh(t, bshd) for t in (q, k, v, o, do,
                                                           dq, dk, dv)), [])
    assert args["sizes"] == (B, H, K, S, S) and args["hd"] == 256
    assert (args["causal"], args["window"]) == (1, 16)
    assert TK.bwd_groups(1, 1, 16, 132) == 16 == args["groups"]
    assert args["ptrs"][10] != 0 and args["parts"] == TK.BWD_TC_PARTS
    assert (args["stream"], args["scale"]) == (77, 256 ** -0.5)
    after = dict(launch_counts)
    for name, more in ((TK.NAME_BWD, 1), (TK.NAME_BWD_TC256, 1),
                       (TK.NAME_BWD_TC, 0), (TK.NAME_BWD_SHORT, 0),
                       (TK.NAME, 0), (TK.NAME_TC256, 0)):
        assert after.get(name, 0) == before.get(name, 0) + more, name


def test_group_workspace_and_one_group():
    """The workspace of a split call holds both slabs of partial dK and dV,
    float32; a call whose key blocks fill the card takes one group and no
    workspace (gemma3-12b's 8 kv heads at S 4096)."""
    q = torch.zeros(1, dtype=torch.bfloat16)
    ptr, ws = TK._group_parts(q, (1, 16, 1, 64, 64), 16)
    assert ws.dtype == torch.float32 and ws.numel() == 2 * 16 * 64 * 256
    assert ptr == ws.data_ptr()
    assert TK._group_parts(q, (1, 16, 8, 64, 64), 1) == (0, None)


def test_hd_240_is_padded_to_256(monkeypatch):
    """gemma3-12b's layout at hd 240 (16 heads over 8, window 1,024) in the
    (B, S, H, hd) layout: the inputs are zero-padded to 256 (copies), the
    scale is 240's, the gradients come back at 240, and its groups are
    `bwd_groups`' (of G = 2)."""
    fake = _plumbing(monkeypatch)
    B, H, K, S, hd = 1, 16, 8, 256, 240
    q, k, v, o, do, lse = _layout(B, H, K, S, hd, True)
    dq, dk, dv = TK.flash_attention_bshd_bwd(q, k, v, o, lse, do,
                                             causal=True, window=1024)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    (f,) = fake.calls
    args = _fields(f)
    assert args["ptrs"][0] != q.data_ptr() and args["hd"] == 256
    assert args["scale"] == 240 ** -0.5 and args["window"] == 1024
    assert args["groups"] == TK.bwd_groups(B * K, S // TK.BWD_KEYS, H // K,
                                           132)
    assert (args["ptrs"][10] != 0) == (args["groups"] > 1)


def test_a_failed_launch_raises_and_counts_nothing(monkeypatch):
    """A launch that returns a CUDA error raises, naming the entry point,
    and leaves every count as it was."""
    _plumbing(monkeypatch, err=700)
    q, k, v, o, do, lse = _layout(1, 16, 1, 64, 256, True)
    before = dict(launch_counts)
    with pytest.raises(RuntimeError, match="flash_bwd_tc256_launch failed"):
        TK.flash_attention_bshd_bwd(q, k, v, o, lse, do, causal=True,
                                    window=16)
    assert dict(launch_counts) == before


@pytest.mark.parametrize("bshd", [False, True])
def test_meta_calls_record_the_backward_work(monkeypatch, bshd):
    """On the meta device a backward on the new route builds and launches
    nothing, gives meta gradients of the inputs' shapes and records
    `cost.flash(..., backward=True)` at the true head dim under
    `flash_attention_bwd`, as every backward did before."""
    def missing():
        raise AssertionError("a meta call asked for the library")
    monkeypatch.setattr(TK, "_library_bwd_tc256", missing)
    B, S, H, K, hd = 1, 4096, 16, 1, 256
    shape_q = (B, S, H, hd) if bshd else (B, H, S, hd)
    shape_k = (B, S, K, hd) if bshd else (B, K, S, hd)
    q, o, do = (torch.empty(shape_q, dtype=torch.bfloat16, device="meta")
                for _ in range(3))
    k, v = (torch.empty(shape_k, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    lse = torch.empty(B, H, S, device="meta")
    bwd = TK.flash_attention_bshd_bwd if bshd else TK.flash_attention_bwd
    before, launches = dict(meta_counts), dict(launch_counts)
    grads = bwd(q, k, v, o, lse, do, causal=True, window=2048)
    assert all(g.device.type == "meta" for g in grads)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    nbytes, ops = cost.flash(B, H, K, S, S, hd, 2, True, 2048, backward=True)
    for key, want in (("calls", 1), ("bytes", nbytes), ("flops", ops)):
        assert meta_counts[TK.NAME_BWD, key] - before.get(
            (TK.NAME_BWD, key), 0) == want
    assert dict(launch_counts) == launches
