"""The port's model-zoo configs (`repro_torch.configs`) against
`repro.configs`: the registry, every config and its `reduced()` field for
field, the input shapes, and `init_params` trees path for path and shape
for shape. densenet-fl's `cnn` kind, which is not a block of the
transformer stack, raises there, naming its model's module."""

import dataclasses

import jax
import pytest
import torch

from repro.configs import base as RB
from repro.models import transformer as RT
from repro_torch.configs import base as TB
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ARCHS = RB.list_configs()
# the transformer stack's configs: dense and MoE attention stacks, global
# and local, Mamba-2, RG-LRU (recurrentgemma), the encoder-decoder
# (whisper) and the vision frontend (phi-3-vision); densenet-fl raises
SERVED = ["gemma3-12b", "h2o-danube-1.8b", "mamba2-370m", "minitron-4b",
          "mixtral-8x7b", "phi-3-vision-4.2b", "qwen3-8b", "qwen3-8b-swa",
          "qwen3-moe-30b-a3b", "recurrentgemma-9b", "whisper-base"]
UNPORTED = ["densenet-fl"]


def _fields(cfg):
    """Every field by name, stages as (pattern, repeats) tuples."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["stages"] = tuple((s.pattern, s.repeats) for s in cfg.stages)
    return out


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype)) for path, leaf in flat}


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    out = {}
    for k, v in items:
        out.update(_port_paths(v, prefix + (k,)))
    return out


def test_registry_lists_the_reference_configs():
    assert TB.list_configs() == ARCHS
    assert len(ARCHS) == 12
    assert TB._CONFIG_MODULES == RB._CONFIG_MODULES
    assert sorted(SERVED + UNPORTED) == ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        TB.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_equal_field_for_field(arch):
    rc, tc = RB.get_config(arch), TB.get_config(arch)
    assert _fields(tc) == _fields(rc)
    assert tc.layer_kinds == rc.layer_kinds
    assert tc.resolved_head_dim == rc.resolved_head_dim
    assert _fields(tc.reduced()) == _fields(rc.reduced())
    over = dict(window_size=8, moe_capacity_factor=0.5)
    assert _fields(tc.reduced(**over)) == _fields(rc.reduced(**over))


def test_defaults_are_the_references_and_keyword_callers_still_work():
    """Every default the reference has is the port's; the two fields the
    reference requires (arch_type, vocab_size) default to the transformer
    payload's dense stack without a vocabulary."""
    ref = {f.name: f.default for f in dataclasses.fields(RB.ModelConfig)}
    for f in dataclasses.fields(TB.ModelConfig):
        if f.name in ("arch_type", "vocab_size"):
            assert ref[f.name] is dataclasses.MISSING
        else:
            assert f.default == ref[f.name], f.name
    cfg = TB.ModelConfig(name="t", num_layers=2, d_model=32, num_heads=4,
                         num_kv_heads=2, d_ff=64,
                         stages=(TB.StageSpec(("global",), 2),))
    assert (cfg.arch_type, cfg.vocab_size) == ("dense", 0)
    cfg.validate()


def test_input_shapes_equal():
    assert {k: dataclasses.astuple(v) for k, v in TB.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in RB.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", SERVED)
def test_init_params_trees_match(arch):
    rc, tc = RB.get_config(arch).reduced(), TB.get_config(arch).reduced()
    rp = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rc))
    tp = TT.init_params(0, tc, device="cpu")
    assert _port_paths(tp) == _ref_paths(rp)
    # a stage leaf leads with its repeats, as the reference's vmap
    for spec, stage in zip(tc.stages, tp["stages"]):
        assert all(v[0][0] == spec.repeats
                   for v in _port_paths(stage).values())


@pytest.mark.parametrize("arch", UNPORTED)
def test_families_outside_the_slice_raise(arch):
    cfg = TB.get_config(arch).reduced()
    for call in (lambda: TT.init_params(0, cfg, device="cpu"),
                 lambda: TT.forward({}, {"tokens": None}, cfg),
                 lambda: TT.init_decode_state(None, cfg, 1, 8, torch.float32,
                                              device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="repro_torch.models.densenet"):
            call()


def test_generator_draws_keep_the_host_bits():
    """A CPU generator draws what it drew before initialisers learned
    other devices: float32 on the host, scaled, then cast."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    w = TL.dense_init(g1, 16, 8, torch.bfloat16)
    want = (torch.randn((16, 8), generator=g2) * 16 ** -0.5).to(
        torch.bfloat16)
    assert torch.equal(w, want) and w.device.type == "cpu"
    e = TL.embedding_init(torch.Generator().manual_seed(0),
                          TB.get_config("mamba2-370m").reduced())
    assert set(e) == {"embed"}          # tied: no lm_head
    assert abs(e["embed"].std().item() - 0.02) < 0.002


def test_decode_state_shape_matches_the_reference():
    """The meta-device state has the reference's abstract state's shapes
    and dtypes, and holds no memory."""
    from repro.launch import steps as RS
    for arch in ("gemma3-12b", "mamba2-370m"):
        shape = RB.ShapeConfig("s", 64, 3, "decode")
        rstate, _ = RS.make_decode_state_shape(RB.get_config(arch).reduced(),
                                               shape)
        tstate = TS.make_decode_state_shape(TB.get_config(arch).reduced(),
                                            TB.ShapeConfig("s", 64, 3,
                                                           "decode"))
        assert tstate["index"] == 0
        rleaves = jax.tree.leaves(rstate["caches"])
        tleaves = [t for c in tstate["caches"] for node in c.values()
                   for t in node]
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                for t in tleaves] == [(tuple(r.shape), str(r.dtype))
                                      for r in rleaves]
        assert all(t.device.type == "meta" for t in tleaves)
