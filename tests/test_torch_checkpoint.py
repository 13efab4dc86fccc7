"""Checkpoints in the port against ``repro``'s: the same directory layout,
leaf names, dtypes and manifest, so each package restores the other's;
round trips, the async writer; and a service saved by either package
loaded by the other, then continued bitwise ``repro``'s uninterrupted
service after an append (N=512, C=8, chunks of 128, as
``tests/test_service.py``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as j_ckpt  # noqa: E402
from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.serve import CounterfactualService as JService  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import AuctionRule  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.launch.mesh import (ShardedLog, SweepMeshSpec,  # noqa: E402
                                     event_sharding, replicated)
from repro_torch.serve import CounterfactualService  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    rng = np.random.default_rng(3)
    return {
        "b": [rng.uniform(size=(4, 3)).astype(np.float32),
              rng.integers(0, 9, (5,)).astype(np.int32)],
        "a": {"z": rng.uniform(size=(2,)) < 0.5,
              "y": np.float32(0.25) * np.ones((), np.float32)},
        "c": None,
    }


def _as_torch(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree.numpy() if isinstance(
        tree, torch.Tensor) else tree)}


def test_layout_and_manifest_are_repros(tmp_path):
    """The same tree written by both packages: the same files, leaf names
    (``jax.tree_util``'s paths), shapes, dtypes and bytes."""
    tree = _tree()
    ours = save_checkpoint(tmp_path / "port", 7, _as_torch(tree),
                           extra={"x": 1})
    theirs = j_ckpt.save_checkpoint(tmp_path / "repro", 7, tree,
                                    extra={"x": 1})
    assert ours.name == theirs.name == "step_00000007"
    assert sorted(p.name for p in ours.iterdir()) == \
        sorted(p.name for p in theirs.iterdir())
    m_ours = json.loads((ours / "manifest.json").read_text())
    m_theirs = json.loads((theirs / "manifest.json").read_text())
    assert m_ours["leaves"] == m_theirs["leaves"]
    assert list(m_ours["leaves"]) == ["a/y", "a/z", "b/0", "b/1"]
    assert m_ours["extra"] == m_theirs["extra"] and m_ours["step"] == 7
    with np.load(ours / "arrays.npz") as a, np.load(theirs / "arrays.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_round_trip_across_packages(tmp_path, writer):
    """Written by one package, restored by both into the structure of a
    ``like`` tree: every leaf's values and dtype, the manifest's extra."""
    tree = _tree()
    if writer == "port":
        save_checkpoint(tmp_path, 3, _as_torch(tree), extra={"k": [1, 2]})
    else:
        j_ckpt.save_checkpoint(tmp_path, 3, tree, extra={"k": [1, 2]})
    got, manifest = restore_checkpoint(tmp_path, _as_torch(tree),
                                       device="cpu")
    want, j_manifest = j_ckpt.restore_checkpoint(tmp_path, tree)
    assert manifest["extra"] == j_manifest["extra"] == {"k": [1, 2]}
    assert got["c"] is None and list(got) == list(tree)
    assert isinstance(got["b"][0], torch.Tensor)
    g, w, t = _leaves(got), _leaves(jax.device_get(want)), _leaves(tree)
    assert sorted(g) == sorted(w) == sorted(t)
    for key in t:
        assert g[key].dtype == w[key].dtype == t[key].dtype
        np.testing.assert_array_equal(g[key], t[key])
        np.testing.assert_array_equal(w[key], t[key])


def test_steps_missing_leaves_and_sharding(tmp_path):
    assert latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore_checkpoint(tmp_path, {"a": 0}, device="cpu")
    for step in (2, 11, 5):
        save_checkpoint(tmp_path, step, {"a": torch.full((2,), step)})
    assert latest_step(tmp_path) == j_ckpt.latest_step(tmp_path) == 11
    got, _ = restore_checkpoint(tmp_path, {"a": 0}, step=5, device="cpu")
    assert got["a"].tolist() == [5, 5]
    got, _ = restore_checkpoint(tmp_path, {"a": 0}, device="cpu")
    assert got["a"].tolist() == [11, 11]
    with pytest.raises(KeyError, match="checkpoint missing leaf b"):
        restore_checkpoint(tmp_path, {"b": 0}, device="cpu")
    # shardings: None keeps a leaf on the device; a sharding places it
    got, _ = restore_checkpoint(tmp_path, {"a": 0}, device="cpu",
                                shardings={"a": None})
    assert got["a"].tolist() == [11, 11]
    spec = SweepMeshSpec.for_devices(devices=["cpu"] * 2)
    got, _ = restore_checkpoint(tmp_path, {"a": 0},
                                shardings={"a": event_sharding(spec)})
    assert isinstance(got["a"], ShardedLog)
    assert [s.tolist() for s in got["a"].shards] == [[11], [11]]
    got, _ = restore_checkpoint(tmp_path, {"a": 0},
                                shardings=replicated(spec))
    assert got["a"].tolist() == [11, 11]
    with pytest.raises(ValueError, match="ragged shard"):
        restore_checkpoint(tmp_path, {"a": 0}, shardings=event_sharding(
            SweepMeshSpec.for_devices(devices=["cpu"] * 4)))
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ckpt = AsyncCheckpointer(tmp_path, keep=2)
    for step in range(4):
        ckpt.save(step, {"w": torch.arange(3) + step}, extra={"s": step})
        ckpt.wait()
    ckpt.close()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    got, manifest = j_ckpt.restore_checkpoint(tmp_path, {"w": 0})
    assert manifest["extra"] == {"s": 3}
    np.testing.assert_array_equal(np.asarray(got["w"]), [3, 4, 5])


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ckpt = AsyncCheckpointer(blocker)
    ckpt.save(0, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ckpt.wait()
    ckpt.close()


# ---------------------------------------------------------------------------
# A service saved by one package, loaded by the other
# ---------------------------------------------------------------------------

_N, _C, _EPC = 512, 8, 128


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(2), n_events=_N,
                              n_campaigns=_C, emb_dim=6)


@pytest.fixture(scope="module")
def grids(env):
    base = JRule.first_price(_C)
    rules = [base, base.with_multiplier(2, 1.7), base.with_multiplier(5, 0.4),
             JRule(multipliers=jnp.full((_C,), 1.2, jnp.float32),
                   reserve=jnp.asarray(0.05, jnp.float32),
                   kind="first_price")]
    budgets = [env.budgets, env.budgets * 0.7, env.budgets * 1.3,
               env.budgets]
    grid = JGrid.from_scenarios(list(zip(rules, budgets)))
    values, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device="cpu")
    return grid, values, port_grid


PARTITION = (256, 128, 128)     # the first two saved, the last appended


def _repro_service(env, store, n):
    base = JRule.first_price(_C)
    svc = JService(env.budgets, base, events_per_chunk=_EPC, store=store)
    svc.register("base")
    svc.register("hot2", rule=base.with_multiplier(2, 1.7))
    svc.register("sp", rule=JRule.second_price(_C))
    start = 0
    for size in PARTITION:
        if start < n:
            svc.append(env.values[start:start + size])
        start += size
    return svc


def _port_service(env, values, store, n):
    base = AuctionRule.first_price(_C, device="cpu")
    svc = CounterfactualService(torch.from_numpy(np.array(env.budgets)),
                                base, events_per_chunk=_EPC, store=store,
                                device="cpu")
    svc.register("base")
    svc.register("hot2", rule=base.with_multiplier(2, 1.7))
    svc.register("sp", rule=AuctionRule.second_price(_C, device="cpu"))
    start = 0
    for size in PARTITION:
        if start < n:
            svc.append(values[start:start + size])
        start += size
    return svc


def _assert_same_service(want, got, grid, port_grid):
    for label in ("base", "hot2", "sp"):
        a, b = want.streaming(label), got.streaming(label)
        np.testing.assert_array_equal(b.final_spend.numpy(), a.final_spend)
        np.testing.assert_array_equal(b.cap_times.numpy(), a.cap_times)
        assert a.log_version == b.log_version
    a, b = want.sweep(grid), got.sweep(port_grid)
    np.testing.assert_array_equal(b.results.final_spend.numpy(),
                                  np.asarray(a.results.final_spend))
    np.testing.assert_array_equal(b.results.cap_times.numpy(),
                                  np.asarray(a.results.cap_times))
    assert want.n_events == got.n_events


@pytest.mark.parametrize("store", ["device", "host"])
@pytest.mark.parametrize("writer", ["repro", "port"])
def test_service_checkpoint_crosses_packages(tmp_path, env, grids, store,
                                             writer):
    """384 events in, saved by ``writer``, loaded by the other package,
    then the last 128 appended: streaming frontiers (three lanes, both
    kinds; the last fold starts inside block 12 of the grown log's
    16-event grid) and exact answers bitwise ``repro``'s service that
    never stopped."""
    grid, values, port_grid = grids
    uninterrupted = _repro_service(env, store, _N)
    if writer == "repro":
        _repro_service(env, store, 384).save(tmp_path)
        restored = CounterfactualService.load(tmp_path, device="cpu")
        assert restored.store == store and restored.log_version == 2
        restored.append(values[384:])
    else:
        _port_service(env, values, store, 384).save(tmp_path)
        restored = JService.load(tmp_path)
        assert restored.store == store and restored.log_version == 2
        restored.append(env.values[384:])
        port_twin = _port_service(env, values, store, _N)
        _assert_same_service(restored, port_twin, grid, port_grid)
        return
    assert restored.stats["registered"] == 3
    _assert_same_service(uninterrupted, restored, grid, port_grid)


def _day():
    env = make_synthetic_env(jax.random.PRNGKey(4), n_events=1024,
                             n_campaigns=8, emb_dim=6)
    grid = JGrid.product(JRule.first_price(8), env.budgets,
                         bid_scales=[1.0, 1.2], budget_scales=[1.0, 0.6])
    return env, grid


def test_repro_checkpoint_restores_onto_a_port_mesh(tmp_path):
    """A log ``repro`` saved restores onto a port mesh of four CPU shards
    (its rows split in rank order, the budgets replicated), and the
    sharded sweep of it is bitwise ``repro``'s batched sweep."""
    from repro.core import SweepPlan as JPlan
    from repro.core import execute_sweep as j_execute
    from repro_torch.core import SweepPlan, execute_sweep
    env, grid = _day()
    j_ckpt.save_checkpoint(tmp_path, 3, {"values": env.values,
                                         "budgets": grid.budgets})
    spec = SweepMeshSpec.for_devices(devices=["cpu"] * 4)
    tree, manifest = restore_checkpoint(
        tmp_path, {"values": 0, "budgets": 0},
        shardings={"values": event_sharding(spec),
                   "budgets": replicated(spec)})
    assert manifest["step"] == 3
    log = tree["values"]
    assert isinstance(log, ShardedLog) and log.shape == (1024, 8)
    assert log.offsets == (0, 256, 512, 768)
    np.testing.assert_array_equal(log.full().numpy(), np.asarray(env.values))
    _, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, device="cpu")
    got = execute_sweep(log, tree["budgets"], port_grid.rules,
                        SweepPlan(placement="sharded", mesh=spec))
    want = j_execute(env.values, grid.budgets, grid.rules,
                     JPlan(placement="batched", resolve="jnp"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_four_shard_save_restores_onto_two_shards(tmp_path):
    """The elastic restore: a log saved from four shards (written as its
    logical value) restores onto two, whose shards are the halves of the
    log; the sweeps on both meshes are bitwise the batched sweep, and
    ``repro`` reads the same checkpoint as the whole log."""
    from repro_torch.core import SweepPlan, execute_sweep
    env, grid = _day()
    values, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, device="cpu")
    four = SweepMeshSpec.for_devices(devices=["cpu"] * 4)
    two = SweepMeshSpec.for_devices(devices=["cpu"] * 2)
    log4 = event_sharding(four).place(values)
    save_checkpoint(tmp_path, 1, {"values": log4})
    tree, _ = restore_checkpoint(tmp_path, {"values": 0},
                                 shardings={"values": event_sharding(two)})
    log2 = tree["values"]
    assert len(log2.shards) == 2 and log2.offsets == (0, 512)
    assert torch.equal(log2.shards[1], values[512:])
    want = execute_sweep(values, port_grid.budgets, port_grid.rules,
                         SweepPlan())
    for spec, log in ((four, log4), (two, log2)):
        got = execute_sweep(log, port_grid.budgets, port_grid.rules,
                            SweepPlan(placement="sharded", mesh=spec))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    j_tree, _ = j_ckpt.restore_checkpoint(tmp_path, {"values": 0})
    np.testing.assert_array_equal(np.asarray(j_tree["values"]),
                                  values.numpy())
