"""Resumable folds and host-streamed logs in the port against ``repro`` on
the same inputs (``repro.data.make_synthetic_env``, N=2048, C=12, S=4),
bit for bit: folds whose windows start inside a canonical block on every
back-end's plain version (``torch``, ``fused``, ``sweep_resolve`` and the
any-C back-end), chunked within a slab and streamed from host memory;
``carry_from_reference``; the host stream's chunks; and the errors'
texts."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import execute_sweep as j_execute_sweep  # noqa: E402
from repro.core import execute_sweep_resumable as j_resumable  # noqa: E402
from repro.core.executor import ChunkSpec as JChunkSpec  # noqa: E402
from repro.core.executor import HostStream as JHostStream  # noqa: E402
from repro.core.executor import SweepPlan as JPlan  # noqa: E402
from repro.core.executor import \
    check_append_alignment as j_check_append  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import (AuctionRule, ChunkSpec, HostStream,  # noqa: E402
                              SweepCarry, SweepPlan, execute_sweep,
                              execute_sweep_resumable, executor,
                              initial_carry)
from repro_torch.interop import carry_from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, C = 2048, 12
BLOCK = N // 32
# slabs whose later folds start inside a canonical block of the grown log
# (600 of 1400: block 44; 1400 of 2048: block 64)
MID_BLOCK = (600, 800, 648)
KINDS = ("first_price", "second_price")


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(5), n_events=N,
                              n_campaigns=C, emb_dim=6)


def _batch(env, kind):
    mult = jnp.stack([jnp.ones(C), jnp.full(C, 1.2), jnp.full(C, 0.9),
                      jnp.linspace(0.8, 1.3, C)]).astype(jnp.float32)
    rule = JRule(multipliers=mult,
                 reserve=jnp.array([0.0, 0.05, 0.0, 0.02], jnp.float32),
                 kind=kind)
    budgets = jnp.stack([env.budgets, env.budgets * 0.7, env.budgets * 1.3,
                         env.budgets * 0.5])
    port_rule = AuctionRule(multipliers=_t(rule.multipliers),
                            reserve=_t(rule.reserve), kind=kind)
    return rule, budgets, port_rule, _t(budgets)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(got, want)


def _fold_all(fold, values, partition, carry=None):
    outs, start = [], 0
    for n in partition:
        out, carry = fold(values[start:start + n], carry)
        outs.append(out)
        start += n
    return outs, carry


def _repro_folds(env, kind, partition, **plan):
    rule, budgets, _, _ = _batch(env, kind)
    return _fold_all(
        lambda v, c: j_resumable(v, budgets, rule, JPlan(**plan), carry=c),
        env.values, partition)


def _assert_folds(want, got):
    (w_outs, w_carry), (g_outs, g_carry) = want, got
    for w_out, g_out in zip(w_outs, g_outs):
        for a, b in zip(w_out, g_out):
            _same(a, b)
    for name in ("s_hat", "active", "cap_times", "n_hat"):
        _same(getattr(w_carry, name), getattr(g_carry, name))
    assert w_carry.n_events_seen == g_carry.n_events_seen


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("resolve", ["torch", "fused", "sweep_resolve"])
def test_mid_block_folds_are_repros(env, kind, resolve):
    """Every fold after the first starts inside a canonical block; on each
    back-end's plain version the outputs of every fold and the carry are
    ``repro``'s bits (the fused back-end takes two ``sweep_partials``
    passes at the offset, the others place their partials there)."""
    assert all(n % BLOCK for n in np.cumsum(MID_BLOCK)[:-1])
    _, _, rule, budgets = _batch(env, kind)
    values = _t(env.values)
    got = _fold_all(lambda v, c: execute_sweep_resumable(
        v, budgets, rule, SweepPlan(resolve=resolve), carry=c),
        values, MID_BLOCK)
    _assert_folds(_repro_folds(env, kind, MID_BLOCK), got)


@pytest.mark.parametrize("kind", KINDS)
def test_mid_block_folds_on_the_any_c_back_end(env, kind, monkeypatch):
    """The back-end a C above the round kernels' limits takes on CUDA
    (every lane of a round through one ``resolve_lanes`` call), forced
    here, folds to ``repro``'s bits at the same offsets."""
    monkeypatch.setattr(executor, "pick_resolve",
                        lambda *a, **k: executor.ANY_C_BACKEND)
    _, _, rule, budgets = _batch(env, kind)
    got = _fold_all(lambda v, c: execute_sweep_resumable(
        v, budgets, rule, SweepPlan(), carry=c), _t(env.values), MID_BLOCK)
    _assert_folds(_repro_folds(env, kind, MID_BLOCK), got)


@pytest.mark.parametrize("resolve", ["torch", "fused"])
def test_chunked_folds_are_repros(env, resolve):
    """Event chunks within each slab (aligned folds: chunks of 256 on the
    32-event block of 1024 events and the 64-event block of 2048)."""
    partition, chunks = (1024, 1024), 256
    _, _, rule, budgets = _batch(env, "second_price")
    got = _fold_all(lambda v, c: execute_sweep_resumable(
        v, budgets, rule, SweepPlan(resolve=resolve, chunks=chunks),
        carry=c), _t(env.values), partition)
    _assert_folds(_repro_folds(env, "second_price", partition,
                               chunks=chunks), got)


@pytest.mark.parametrize("prefetch", [True, False])
def test_host_streamed_folds_are_repros(env, prefetch):
    """Folds of slabs streamed from host memory, each slab two
    ``HostStream`` slabs, so a chunk straddles them: 992 events in chunks
    of 248 (block 31), then 1,008 more in chunks of 252 (block 63 of
    2,000), a fold that starts inside block 15. ``repro``'s host-streamed
    folds' bits, which are its device folds'."""
    partition, epcs = (992, 1008), (248, 252)
    rule, budgets, port_rule, port_budgets = _batch(env, "first_price")
    values, j_values = _t(env.values), env.values
    got, want, want_device = [], [], []
    carry = j_carry = j_dev = None
    start = 0
    for n, epc in zip(partition, epcs):
        v = values[start:start + n]
        halves = [v[:n // 2 + 1], v[n // 2 + 1:]]
        out, carry = execute_sweep_resumable(
            HostStream(halves), port_budgets, port_rule,
            SweepPlan(chunks=ChunkSpec(epc, source="host",
                                       prefetch=prefetch)), carry=carry)
        got.append(out)
        j_out, j_carry = j_resumable(
            JHostStream([np.asarray(j_values[start:start + n])]), budgets,
            rule, JPlan(chunks=JChunkSpec(epc, source="host")),
            carry=j_carry)
        want.append(j_out)
        j_out, j_dev = j_resumable(j_values[start:start + n], budgets, rule,
                                   JPlan(), carry=j_dev)
        want_device.append(j_out)
        start += n
    assert sum(partition[:1]) % 63
    _assert_folds((want, j_carry), (got, carry))
    _assert_folds((want_device, j_dev), (got, carry))


def test_one_fold_is_the_one_shot_sweep(env):
    _, _, rule, budgets = _batch(env, "first_price")
    values = _t(env.values)
    out, carry = execute_sweep_resumable(values, budgets, rule, SweepPlan())
    for a, b in zip(execute_sweep(values, budgets, rule, SweepPlan()), out):
        assert torch.equal(a, b)
    assert carry.n_events_seen == N and carry.num_scenarios == 4
    assert carry.num_campaigns == C


def test_carry_from_reference_continues_bitwise(env):
    """``repro``'s carry after two folds, carried into the port, folds the
    third slab to ``repro``'s bits."""
    rule, budgets, port_rule, port_budgets = _batch(env, "second_price")
    (_, j_carry) = _fold_all(
        lambda v, c: j_resumable(v, budgets, rule, JPlan(), carry=c),
        env.values, MID_BLOCK[:2])
    start = sum(MID_BLOCK[:2])
    want, want_carry = j_resumable(env.values[start:], budgets, rule,
                                   JPlan(), carry=j_carry)
    carry = carry_from_reference(jax.device_get(j_carry), device="cpu")
    assert carry.n_events_seen == start
    assert carry.active.dtype == torch.bool
    assert carry.cap_times.dtype == carry.n_hat.dtype == torch.int32
    got, got_carry = execute_sweep_resumable(
        _t(env.values[start:]), port_budgets, port_rule, SweepPlan(),
        carry=carry)
    _assert_folds(([want], want_carry), ([got], got_carry))


def test_carry_pickle_round_trip(env):
    _, _, rule, budgets = _batch(env, "first_price")
    values = _t(env.values)
    _, carry = execute_sweep_resumable(values[:600], budgets, rule,
                                       SweepPlan())
    thawed = pickle.loads(pickle.dumps(carry))
    assert isinstance(thawed, SweepCarry) and thawed.n_events_seen == 600
    a, _ = execute_sweep_resumable(values[600:], budgets, rule, SweepPlan(),
                                   carry=carry)
    b, _ = execute_sweep_resumable(values[600:], budgets, rule, SweepPlan(),
                                   carry=thawed)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_initial_carry_is_repros():
    from repro.core import initial_carry as j_initial
    want, got = j_initial(3, C), initial_carry(3, C, device="cpu")
    for name in ("s_hat", "active", "cap_times", "n_hat"):
        _same(getattr(want, name), getattr(got, name))
    assert got.n_events_seen == want.n_events_seen == 0


def test_host_stream_chunks():
    """Views inside one slab, windows across slabs put together (into a
    caller's buffer too), and ``repro``'s texts for bad slabs and
    windows."""
    rng = np.random.default_rng(0)
    slabs = [rng.uniform(size=(n, 3)).astype(np.float32) for n in (5, 7, 4)]
    stream = HostStream([torch.from_numpy(s) for s in slabs])
    whole = np.concatenate(slabs)
    assert stream.shape == (16, 3) and stream.n_events == 16
    assert stream.n_campaigns == 3 and stream.ndim == 2
    inside = stream.chunk(6, 11)
    assert inside.data_ptr() == stream._slabs[1][1:].data_ptr()
    assert not stream.straddles(5, 12) and stream.straddles(4, 6)
    for start, stop in ((0, 16), (3, 13), (5, 12), (12, 16)):
        np.testing.assert_array_equal(stream.chunk(start, stop).numpy(),
                                      whole[start:stop])
    out = torch.zeros((10, 3))
    got = stream.chunk(3, 13, out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(out.numpy(), whole[3:13])
    j_stream = JHostStream(slabs)
    for bad in ((5, 5), (-1, 3), (10, 17)):
        with pytest.raises(ValueError) as want:
            j_stream.chunk(*bad)
        with pytest.raises(ValueError) as err:
            stream.chunk(*bad)
        assert str(err.value) == str(want.value)
    for bad in ([], [np.zeros((0, 3), np.float32)],
                [np.zeros((2, 3), np.float32), np.zeros((2, 4), np.float32)]):
        with pytest.raises(ValueError) as want:
            JHostStream(bad)
        with pytest.raises(ValueError) as err:
            HostStream([torch.from_numpy(b) for b in bad])
        assert str(err.value) == str(want.value)


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_errors_are_repros(env):
    rule, budgets, port_rule, port_budgets = _batch(env, "first_price")
    values = _t(env.values)
    cases = [
        (dict(placement="device"), dict(placement="device"), {}),
        (dict(scenario_chunks=2), dict(scenario_chunks=2), {}),
        (dict(chunks=JChunkSpec(256, source="host"), scenario_chunks=2),
         dict(chunks=ChunkSpec(256, source="host"), scenario_chunks=2), {}),
        (dict(chunks=JChunkSpec(300)), dict(chunks=ChunkSpec(300)), {}),
    ]
    for j_plan, plan, _ in cases:
        assert _message(lambda: execute_sweep_resumable(
            values, port_budgets, port_rule, SweepPlan(**plan))) == \
            _message(lambda: j_resumable(env.values, budgets, rule,
                                         JPlan(**j_plan)))
    assert _message(lambda: execute_sweep_resumable(
        values[:0], port_budgets, port_rule, SweepPlan())) == \
        _message(lambda: j_resumable(env.values[:0], budgets, rule, JPlan()))
    assert _message(lambda: execute_sweep_resumable(
        values, port_budgets, port_rule, SweepPlan(),
        carry=initial_carry(2, C, device="cpu"))) == \
        _message(lambda: j_resumable(env.values, budgets, rule, JPlan(),
                                     carry=initial_carry_j(2)))
    # the host-streamed sweep's contract
    stream = HostStream([values])
    j_stream = JHostStream([np.asarray(env.values)])
    assert _message(lambda: execute_sweep(stream, port_budgets, port_rule,
                                          SweepPlan())) == \
        _message(lambda: j_execute_sweep(j_stream, budgets, rule, JPlan()))
    for n in (100, 256, 1000):
        assert _message_or_none(lambda: executor.check_append_alignment(
            ChunkSpec(256), n)) == _message_or_none(
            lambda: j_check_append(JChunkSpec(256), n))


def initial_carry_j(s):
    from repro.core import initial_carry as j_initial
    return j_initial(s, C)


def _message_or_none(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None
