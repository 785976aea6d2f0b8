"""The port's training launcher (`repro_torch.launch.{input_specs,train}`,
`steps.default_num_micro`) against `repro.launch` on the CPU: the input
specs of all 12 configs and shapes, `synthetic_lm_batch` bit for bit,
`train()` lowering the loss, and `python -m repro_torch.launch.train`
exiting 0 on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import INPUT_SHAPES as R_SHAPES
from repro.configs.base import ShapeConfig as RShape
from repro.configs.base import get_config as rget
from repro.configs.base import list_configs
from repro.core.mesh import abstract_mesh
from repro.launch import input_specs as RI
from repro.launch import steps as RS
from repro.launch.train import synthetic_lm_batch as r_batch
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import input_specs as TI
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TR
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.train import synthetic_lm_batch as t_batch

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_configs()


def _same_spec(port, ref):
    assert isinstance(port, TI.Spec)
    assert port.shape == tuple(ref.shape)
    assert str(port.dtype).split(".")[-1] == str(ref.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match(arch):
    assert len(ARCHS) == 12
    for name in R_SHAPES:
        rc, tc = rget(arch), tget(arch)
        rs, ts = R_SHAPES[name], T_SHAPES[name]
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            want, got = getattr(RI, fn)(rc, rs), getattr(TI, fn)(tc, ts)
            assert sorted(got) == sorted(want), (fn, name)
            for k in want:
                _same_spec(got[k], want[k])
        _same_spec(TI.decode_token_spec(tc, ts), RI.decode_token_spec(rc, rs))
        assert TI.applicable(tc, ts) == RI.applicable(rc, rs)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m", "whisper-base",
                                  "phi-3-vision-4.2b", "densenet-fl"])
def test_synthetic_lm_batch_is_the_references_bit_for_bit(arch):
    """Tokens, labels and the frames or image embeddings of the encoder-
    decoder and vision configs, over several steps and seeds."""
    rc, tc = rget(arch).reduced(), tget(arch).reduced()
    for seq, batch in ((24, 3), (40, 2)):
        rs = RShape("t", seq_len=seq, global_batch=batch, kind="train")
        ts = TShape("t", seq_len=seq, global_batch=batch, kind="train")
        for seed in (0, 7):
            for step in (0, 1, 13):
                want = r_batch(rc, rs, step, seed)
                got = t_batch(tc, ts, step, seed, device="cpu")
                assert sorted(got) == sorted(want)
                for k in want:
                    w = np.asarray(want[k])
                    assert got[k].device.type == "cpu"
                    assert got[k].numpy().dtype == w.dtype
                    np.testing.assert_array_equal(got[k].numpy(), w)


def test_default_num_micro_matches():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for batch in (1, 2, 8, 64):
        rs = RShape("t", seq_len=16, global_batch=batch, kind="train")
        ts = TShape("t", seq_len=16, global_batch=batch, kind="train")
        assert TS.default_num_micro(tget("qwen3-8b"), ts) \
            == RS.default_num_micro(rget("qwen3-8b"), rs, mesh)
        # the production mesh's 16 data shards, on its shape alone
        assert TS.default_num_micro(tget("qwen3-8b"), ts,
                                    production_mesh_shape()) \
            == RS.default_num_micro(rget("qwen3-8b"), rs, abstract_mesh(
                (16, 16), ("data", "model")))


def test_train_lowers_the_loss_on_the_cpu(capsys):
    hist = TR.train("qwen3-8b", reduced=True, steps=8, batch=4, seq=32,
                    lr=1e-3, num_micro=2, log_every=4, device="cpu")
    assert len(hist) == 8 and all(np.isfinite(hist))
    assert hist[-1] < hist[0]
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("step")]
    assert [x.split()[1] for x in lines] == ["0", "4", "7"]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_production_meshes_raise(mesh_kind):
    """The production meshes need worlds of 256 and 512 ranks; one process
    is a world of one, and no group is left behind."""
    import torch.distributed as dist
    need = 512 if mesh_kind == "multi" else 256
    with pytest.raises(RuntimeError, match=f"world of {need} ranks"):
        TR.train("qwen3-8b", steps=1, mesh_kind=mesh_kind, device="cpu")
    assert not dist.is_initialized()


def test_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--reduced", "--steps", "3", "--batch", "2",
         "--seq", "32", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "loss:" in out.stdout.splitlines()[-1]


def test_the_train_path_imports_no_jax():
    """The port's train path and the example import neither JAX nor the
    JAX package."""
    code = (
        "import importlib.util, sys\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.launch.input_specs, repro_torch.optim\n"
        "import repro_torch.weights\n"
        "spec = importlib.util.spec_from_file_location('ex', "
        "'examples/satellite_fl_train_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
