"""The port's attention forward at (padded) head dim 256 in bfloat16, the
route of `csrc/flash_fwd_tc256.cu` on the card, held on the CPU:

- the port's `flash_attention` and `flash_attention_bshd` at hd 256 and
  240 (padded to 256 on the card) against the reference's Pallas kernel
  in interpret mode (as tests/test_kernels.py runs it), including the
  decode layout, the G query heads of a kv head as G rows against a
  strided cache prefix;
- the split over keys: `attention_fwd_split_ref` then
  `combine_splits_ref` equal the unsplit plain version for every split
  count, and `decode_splits` with `split_ranges` cover every visible key
  once;
- `forward_route` beside `route` and `short_fits`, and the wrapper's
  plumbing with a stand-in library: the argument block, the strides read
  in place, the splits and the launch counts.
Inputs are made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as r_pallas
from repro_torch.kernels import cost, launch_counts, meta_counts
from repro_torch.kernels.flash_attention import kernel as TK
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bshd)
from repro_torch.kernels.flash_attention.ref import (attention_fwd_ref,
                                                     attention_fwd_split_ref,
                                                     combine_splits_ref)
from test_torch_flash import _fake_cuda_all as _fake

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

# float32: the same float32 arithmetic in another order (the tolerance of
# tests/test_kernels.py's attention sweeps, as in tests/test_torch_flash.py)
F32 = dict(rtol=0, atol=2e-5)
# bfloat16: inputs rounded alike, float32 inside, one rounding of the
# output that may go the other way (test_kernels.py's bfloat16 tolerance)
BF16 = dict(rtol=3e-2, atol=3e-2)
# the splits merged against the unsplit plain version, float32: the same
# softmax summed in pieces and rescaled (up to ~5e-7 read at these sizes)
SPLIT = dict(rtol=1e-6, atol=2e-6)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _inputs(B, H, K, sq, sk, hd, seed, dtype="float32"):
    r = np.random.default_rng(seed)
    arrays = [r.standard_normal(s).astype(np.float32)
              for s in ((B, H, sq, hd), (B, K, sk, hd), (B, K, sk, hd))]
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays])


# (B, H, K, S, hd, causal, window): GQA 4 over 1, causal with a window of
# 3 and without a mask, at hd 256 and 240
PARITY = [(2, 4, 1, 24, hd, causal, window) for hd in (256, 240)
          for causal, window in ((True, 3), (False, 0))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,hd,causal,window", PARITY)
def test_forward_matches_the_pallas_kernel(B, H, K, S, hd, causal, window,
                                           dtype):
    """`flash_attention` and the (B, S, H, hd) entry point against the
    reference's Pallas kernel in interpret mode (blocks of 8), within the
    test_kernels.py tolerance of the dtype; the two layouts give the same
    values."""
    jin, tin = _inputs(B, H, K, S, S, hd, seed=hd + H + window,
                       dtype=dtype)
    kw = dict(causal=causal, window=window)
    pallas = r_pallas(*jin, bq=8, bk=8, interpret=True, **kw)
    o = flash_attention(*tin, **kw)
    o_bshd = flash_attention_bshd(*(t.transpose(1, 2) for t in tin), **kw)
    o_k, lse = TK.flash_attention(*tin, **kw)
    assert o.dtype == tin[0].dtype and lse.shape == (B, H, S)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(o), _np(pallas), **tol)
    np.testing.assert_array_equal(_np(o_bshd.transpose(1, 2)), _np(o))
    np.testing.assert_array_equal(_np(o_k), _np(o))


@pytest.mark.parametrize("hd", [256, 240])
def test_decode_layout_against_a_strided_cache_prefix(hd):
    """The decode step's call as `attention_decode` makes it: q (B, 1, H,
    hd) as (B, K, G, hd), passed as its (B, G, K, hd) view, against the
    first n slots of a (B, T, K, hd) cache as they lie (strided in B),
    non-causal; against the Pallas kernel on (B, K, G, hd) and the
    cache's (B, K, n, hd) prefix."""
    B, K, G, T, n = 2, 2, 4, 10, 7
    r = np.random.default_rng(hd)
    q = r.standard_normal((B, K, G, hd)).astype(np.float32)
    ck, cv = (r.standard_normal((B, T, K, hd)).astype(np.float32)
              for _ in range(2))
    tk, tv = torch.tensor(ck)[:, :n], torch.tensor(cv)[:, :n]
    assert not tk.is_contiguous()
    o = flash_attention_bshd(torch.tensor(q).transpose(1, 2), tk, tv,
                             causal=False)
    assert o.shape == (B, G, K, hd)
    pallas = r_pallas(jnp.asarray(q),
                      jnp.asarray(ck[:, :n].transpose(0, 2, 1, 3)),
                      jnp.asarray(cv[:, :n].transpose(0, 2, 1, 3)),
                      causal=False, bq=4, bk=8, interpret=True)
    np.testing.assert_allclose(_np(o.transpose(1, 2)), _np(pallas), **F32)


# ---------------------------------------------------------------------------
# the split over keys


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 3),
                                           (False, 0)])
def test_splits_then_combine_equal_the_unsplit_forward(causal, window):
    """For every split count from 1 to Sk, the keys cut as the kernel cuts
    them (`split_ranges` at one key a tile, so no range is empty), the
    partial results merged by `combine_splits_ref` equal
    `attention_fwd_ref`. Sq > Sk with a window leaves rows that see no key
    at all (o 0, lse -inf), and the window and causal order leave ranges
    that some rows see nothing of (their partial lse -inf)."""
    B, H, K, sq, sk, hd = 1, 4, 2, 16, 12, 16
    _, (q, k, v) = _inputs(B, H, K, sq, sk, hd, seed=3 + window)
    kw = dict(causal=causal, window=window)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    empty_seen = False
    for splits in range(1, sk + 1):
        ranges = TK.split_ranges(0, sk, splits, tile=1)
        assert all(a < b for a, b in ranges)
        o_parts, lse_parts = attention_fwd_split_ref(q, k, v, ranges, **kw)
        assert o_parts.shape == (splits, B, H, sq, hd)
        assert o_parts.dtype == lse_parts.dtype == torch.float32
        dead = torch.isneginf(lse_parts)
        assert not o_parts[dead].any()
        empty_seen |= bool(dead.any())
        got, got_lse = combine_splits_ref(o_parts, lse_parts)
        np.testing.assert_allclose(got.numpy(), o.float().numpy(), **SPLIT)
        np.testing.assert_array_equal(np.isneginf(got_lse.numpy()),
                                      np.isneginf(lse.numpy()))
        live = ~np.isneginf(lse.numpy())
        np.testing.assert_allclose(got_lse.numpy()[live],
                                   lse.numpy()[live], **SPLIT)
    assert empty_seen == (causal or window > 0)
    if window:
        assert np.isneginf(lse.numpy()).any()      # rows with no key


def test_split_ranges_follow_the_kernel_tiles():
    """`split_ranges` cuts a unit's keys as the kernel does: its tiles of
    `TC256_KEYS` keys from lo, split t taking tiles [t n / splits, (t + 1)
    n / splits); together the ranges cover [lo, hi) once, in order; a
    split past the last tile is empty."""
    for lo, hi in ((0, 2048), (5, 70), (0, 1), (100, 100), (3, 1000)):
        n = -(-(hi - lo) // TK.TC256_KEYS) if hi > lo else 0
        for splits in (1, 2, 3, 5, 32, 80):
            ranges = TK.split_ranges(lo, hi, splits)
            assert len(ranges) == splits
            assert ranges[0][0] == lo and ranges[-1][1] == max(lo, hi)
            for (a, b), (c, _) in zip(ranges, ranges[1:]):
                assert a <= b == c
            for t, (a, b) in enumerate(ranges):
                tiles = n * (t + 1) // splits - n * t // splits
                assert (b - a == 0) == (tiles == 0)
                assert a == min(hi, lo + n * t // splits * TK.TC256_KEYS)


@pytest.mark.parametrize("sm_count", [132, 114, 8])
def test_decode_splits_cover_every_key_once(sm_count):
    """`decode_splits` for decode-shaped calls (few units) gives a count
    whose `split_ranges` cover the visible keys once with non-empty
    ranges, at most `MAX_SPLITS`, and more than one only where the units
    leave the card's SMs idle; prefill-shaped calls (units that fill the
    card) and calls of one kv tile get 1. recurrentgemma-9b's full-window
    decode call (8 units over 2,048 keys) takes 32 splits on 132 SMs."""
    for units in (1, 2, 8, 64, 131, 132, 1024):
        for keys in (1, 31, 32, 33, 160, 576, 2048, 4096, 32768):
            splits = TK.decode_splits(units, keys, sm_count)
            assert 1 <= splits <= TK.MAX_SPLITS
            ranges = TK.split_ranges(0, keys, splits)
            assert ranges[0][0] == 0 and ranges[-1][1] == keys
            assert all(a < b for a, b in ranges)
            assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
            if units >= sm_count or keys <= TK.TC256_KEYS:
                assert splits == 1
            else:
                assert splits * units <= max(
                    units, 2 * TK.DECODE_BLOCKS_PER_SM * sm_count)
    if sm_count == 132:
        assert TK.decode_splits(8, 2048, 132) == 32
        assert TK.decode_splits(16 * 64, 2048, 132) == 1


# ---------------------------------------------------------------------------
# the route and the wrapper's plumbing


def test_forward_route_beside_route_and_short_fits():
    """`forward_route` for every (dtype, hd up to 1,024) and query rows:
    "short" exactly where `short_fits`, "tc256" for the other bfloat16
    calls at padded hd 256, `route`'s answer everywhere else; `route`
    (both directions' kernels, the backward's alone now) keeps its
    answers."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in range(1, 1025):
            width = TK.padded_head_dim(hd)
            assert TK.route(dtype, width) == (
                "tc" if dtype == torch.bfloat16 and 33 <= hd <= 128
                else "cuda_core")
            for G, sq, sk in ((1, 1, 1), (2, 1, 576), (16, 16, 2048),
                              (4, 8, 8), (16, 4096, 4096), (1, 17, 9)):
                got = TK.forward_route(G, sq, sk, width, dtype)
                if TK.short_fits(G, sq, sk, width, dtype):
                    assert got == "short"
                elif dtype == torch.bfloat16 and width == 256:
                    assert got == "tc256", (hd, G, sq, sk)
                else:
                    assert got == TK.route(dtype, width)
    # recurrentgemma-9b's prefill and decode calls, gemma3-12b's decode
    for G, sq, sk, hd in ((16, 4096, 4096, 256), (16, 16, 2048, 256),
                          (2, 2, 576, 240)):
        assert TK.forward_route(G, sq, sk, TK.padded_head_dim(hd),
                                torch.bfloat16) == "tc256"


class _FakeTc256:
    """A stand-in for `_library_tc256()`: the forward and the combine
    entry points record their argument blocks and return `errs`."""

    def __init__(self, errs=(0, 0)):
        self.calls, self.errs = [], errs

    def __call__(self):
        def entry(name, err):
            def launch(block):
                self.calls.append((name, TK.TC256_ARGS.unpack(block)))
                return err
            return launch
        return entry("fwd", self.errs[0]), entry("combine", self.errs[1])


def _fields(f):
    """The `TC256_ARGS` fields by name."""
    return {"ptrs": f[:7], "sizes": f[7:12], "hd": f[12], "causal": f[13],
            "window": f[14], "splits": f[15], "stream": f[16],
            "scale": f[17], "strides": list(f[18:30])}


def _plumbing(monkeypatch, errs=(0, 0)):
    fake = _FakeTc256(errs)
    monkeypatch.setattr(TK, "_library_tc256", fake)
    monkeypatch.setattr(TK, "_stream", lambda t: 77)
    monkeypatch.setattr(TK, "_sm_count", lambda index: 132)
    return fake


def _bsh(t, bshd=True):
    """The (batch, sequence, head) strides the wrapper passes for t, 0
    along a dim of size 1."""
    dims = (0, 1, 2) if bshd else (0, 2, 1)
    return [t.stride(d) if t.shape[d] > 1 else 0 for d in dims]


@pytest.mark.parametrize("hd", [256, 240])
def test_decode_call_reads_the_cache_in_place_and_splits(monkeypatch, hd):
    """The decode call on the card's path (bf16, 16 query rows of one kv
    head, B 8, a cache prefix of 2,048 slots): at hd 256 the wrapper hands
    the forward q's (B, G, K, hd) view and the cache's prefix as they lie
    (no copy), o written in q's strides (so (B, 1, H * hd) is a view of
    it); hd 240 is zero-padded to 256 first and o sliced back. 32 splits
    with one workspace allocation, then the combine with the same block;
    it counts one `flash_attention`, one `flash_attention_tc256` and one
    `flash_attention_combine` launch."""
    fake = _plumbing(monkeypatch)
    B, K, G, T, n = 8, 1, 16, 2048, 2048
    q = torch.zeros(B, K, G, hd, dtype=torch.bfloat16)
    ck = torch.zeros(B, T + 4, K, hd, dtype=torch.bfloat16)
    q, ck = _fake(q, ck)
    qv, kv = q.transpose(1, 2), ck[:, :n]
    before = dict(launch_counts)
    o, lse = TK.flash_attention_bshd(qv, kv, kv, causal=False)
    assert o.shape == qv.shape and lse.shape == (B, K, G)
    assert lse.dtype == torch.float32
    (f, fa), (c, ca) = fake.calls
    assert (f, c) == ("fwd", "combine") and fa == ca
    args = _fields(fa)
    if hd == 256:
        assert o.transpose(1, 2).is_contiguous()
        assert args["ptrs"][:5] == tuple(t.data_ptr() for t in (qv, kv, kv,
                                                               o, lse))
        assert args["strides"] == sum((_bsh(t) for t in (qv, kv, kv, o)),
                                      [])
    else:
        assert args["ptrs"][0] != qv.data_ptr()     # a padded copy
    ws = args["ptrs"][5]
    assert args["ptrs"][6] - ws == 32 * B * K * G * 256 * 4
    assert args["sizes"] == (B, K, K, G, n) and args["hd"] == 256
    assert (args["causal"], args["window"], args["splits"]) == (0, 0, 32)
    assert (args["stream"], args["scale"]) == (77, hd ** -0.5)
    after = dict(launch_counts)
    for name, more in ((TK.NAME, 1), (TK.NAME_TC256, 1),
                       (TK.NAME_COMBINE, 1), (TK.NAME_TC, 0),
                       (TK.NAME_SHORT, 0)):
        assert after.get(name, 0) == before.get(name, 0) + more, name


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("hd", [256, 200])
def test_prefill_call_takes_one_unsplit_launch(monkeypatch, bshd, hd):
    """A prefill-shaped call (recurrentgemma-9b's layout cut to S 64:
    causal, window 16, 16 query heads over 1): one forward launch with
    splits 1 and no workspace, in either layout, q, k, v read in place at
    hd 256; a head dim below it (200) is zero-padded to 256, and o comes
    back at the true hd; no combine."""
    fake = _plumbing(monkeypatch)
    B, H, K, S = 1, 16, 1, 64
    if bshd:
        q, k = torch.ones(B, S, H, hd), torch.ones(B, S, K, hd)
        fwd = TK.flash_attention_bshd
    else:
        q, k = torch.ones(B, H, S, hd), torch.ones(B, K, S, hd)
        fwd = TK.flash_attention
    q, k = _fake(q.bfloat16(), k.bfloat16())
    before = dict(launch_counts)
    o, lse = fwd(q, k, k, causal=True, window=16)
    assert o.shape == q.shape and lse.shape == (B, H, S)
    (name, f), = fake.calls
    args = _fields(f)
    assert name == "fwd" and args["ptrs"][5:] == (0, 0)
    assert (args["splits"], args["causal"], args["window"]) == (1, 1, 16)
    assert args["hd"] == 256 and args["scale"] == hd ** -0.5
    if hd == 256:
        assert args["ptrs"][0] == q.data_ptr()
        assert args["strides"][:6] == _bsh(q, bshd) + _bsh(k, bshd)
    after = dict(launch_counts)
    assert after.get(TK.NAME_TC256, 0) == before.get(TK.NAME_TC256, 0) + 1
    assert after.get(TK.NAME_COMBINE, 0) == before.get(TK.NAME_COMBINE, 0)


def test_a_failed_launch_raises(monkeypatch):
    """A forward launch that returns a CUDA error raises and counts
    nothing; a failed combine raises after the forward's counts."""
    q, k = _fake(torch.ones(8, 16, 1, 256, dtype=torch.bfloat16),
                 torch.ones(8, 512, 1, 256, dtype=torch.bfloat16))
    _plumbing(monkeypatch, errs=(700, 0))
    before = dict(launch_counts)
    with pytest.raises(RuntimeError, match="flash_fwd_tc256_launch failed"):
        TK.flash_attention_bshd(q, k, k, causal=False)
    assert dict(launch_counts) == before
    _plumbing(monkeypatch, errs=(0, 700))
    with pytest.raises(RuntimeError, match="flash_combine_launch failed"):
        TK.flash_attention_bshd(q, k, k, causal=False)
    after = dict(launch_counts)
    assert after.get(TK.NAME_TC256, 0) == before.get(TK.NAME_TC256, 0) + 1
    assert after.get(TK.NAME_COMBINE, 0) == before.get(TK.NAME_COMBINE, 0)


def test_meta_calls_record_the_same_work(monkeypatch):
    """On the meta device a call on the new route builds and launches
    nothing and records `cost.flash` at the true head dim under
    `flash_attention`, as every forward did before."""
    def missing():
        raise AssertionError("a meta call asked for the library")
    monkeypatch.setattr(TK, "_library_tc256", missing)
    B, S, H, K, hd = 1, 4096, 16, 1, 256
    q = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, K, hd, dtype=torch.bfloat16, device="meta")
    before, launches = dict(meta_counts), dict(launch_counts)
    o, lse = TK.flash_attention_bshd(q, k, k, causal=True, window=2048)
    assert o.device.type == "meta" and o.shape == q.shape
    nbytes, ops = cost.flash(B, H, K, S, S, hd, 2, True, 2048)
    for key, want in (("calls", 1), ("bytes", nbytes), ("flops", ops)):
        assert meta_counts[TK.NAME, key] - before.get((TK.NAME, key), 0) \
            == want
    assert dict(launch_counts) == launches
