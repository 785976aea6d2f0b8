"""The port's `CheckpointStore` disk spill (`repro_torch.ckpt.checkpoint`)
against `repro.ckpt.checkpoint.CheckpointStore`: the same versions spilled
under the same file names with the same npz keys, `prune` unlinking the
same files, `get` after eviction from memory loading from disk onto the
device of the stored trees, `versions` listing memory plus disk, and each
package's spilled file loading into the other's tree."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as RCK
from repro_torch.ckpt import checkpoint as TCK
from repro_torch.tree import tree_leaves

# One intra-op thread: the suite runs as several pytest workers on a few
# cores, and torch's OpenMP pool in each worker oversubscribed them.
torch.set_num_threads(1)


def _tree(v):
    """A nested tree (dicts and a list), its values tagged by version."""
    r = np.random.default_rng(v)
    return {"w1": r.normal(size=(4, 3)).astype(np.float32) + v,
            "b": {"scale": np.full((3,), v, np.float32)},
            "blocks": [r.normal(size=(2,)).astype(np.float32),
                       np.arange(5, dtype=np.float32) * v]}


def _stores(tmp_path, keep, every):
    rdir, tdir = tmp_path / "ref", tmp_path / "port"
    ref = RCK.CheckpointStore(str(rdir), keep_in_memory=keep,
                              spill_every=every)
    port = TCK.CheckpointStore(str(tdir), keep_in_memory=keep,
                               spill_every=every)
    for v in range(10):
        t = _tree(v)
        ref.put(v, jax.tree.map(jnp.asarray, t))
        port.put(v, jax.tree.map(torch.tensor, t))
    return (ref, rdir), (port, tdir)


@pytest.mark.parametrize("keep,every", [(3, 2), (4, 3), (2, 1)])
def test_spilled_files_have_the_reference_names_and_keys(tmp_path, keep,
                                                         every):
    (ref, rdir), (port, tdir) = _stores(tmp_path, keep, every)
    names = sorted(os.listdir(rdir))
    assert names == sorted(os.listdir(tdir))
    assert names == [f"w_{v:06d}.npz" for v in range(0, 10, every)]
    for n in names:
        a, b = np.load(rdir / n), np.load(tdir / n)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])
    assert port.versions() == ref.versions()


@pytest.mark.parametrize("keep,every", [(3, 2), (2, 1)])
def test_prune_unlinks_the_spilled_files_below_the_cutoff(tmp_path, keep,
                                                          every):
    (ref, rdir), (port, tdir) = _stores(tmp_path, keep, every)
    for cutoff in (4, 6, 20):
        ref.prune(cutoff)
        port.prune(cutoff)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(rdir))
        assert port.versions() == ref.versions()
    assert all(int(n[2:8]) >= 10 - keep for n in os.listdir(tdir))


def test_get_after_eviction_from_memory_loads_from_disk(tmp_path):
    (ref, _), (port, _) = _stores(tmp_path, 10, 2)
    for store in (ref, port):
        # evicted from memory: version 4 was spilled, 5 was not
        del store._mem[4], store._mem[5]
        with pytest.raises(KeyError):
            store.get(5)
    assert 4 in port.versions() and 5 not in port.versions()
    got = port.get(4)
    want = ref.get(4)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.get(9) is port._mem[9]     # memory first


def test_each_packages_spill_loads_into_the_others_tree(tmp_path):
    (ref, rdir), (port, tdir) = _stores(tmp_path, 10, 3)
    like_t = jax.tree.map(torch.tensor, _tree(0))
    like_r = jax.tree.map(jnp.asarray, _tree(0))
    from_ref = TCK.load_pytree(str(rdir / "w_000006.npz"), like_t)
    from_port = RCK.load_pytree(str(tdir / "w_000006.npz"), like_r)
    for a, b, c in zip(tree_leaves(from_ref), jax.tree.leaves(from_port),
                       jax.tree.leaves(_tree(6))):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(np.asarray(b), c)


def test_the_engine_keeps_a_memory_only_store():
    store = TCK.CheckpointStore(keep_in_memory=4)
    store.put(0, {"w": torch.zeros(2)})
    assert store.dir is None and store.versions() == [0]
