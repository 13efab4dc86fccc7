"""The port's MoE MLP (``repro_torch.models.moe``) and its three MoE models
against ``repro``'s, on the CPU, at ``reduced_config``.

``moe_apply`` on the same bfloat16 inputs and weights from seeded numpy,
``repro``'s run eagerly with its ``jax.lax.top_k`` and ``jnp.einsum``
recorded: the chosen experts and the dispatch tensor (which holds every
slot and every dropped (token, choice) pair) are equal exactly, and so is
the combine tensor; the outputs are within one bfloat16 rounding of their
scale (``OUT_TOL``; measured 0: the same inputs give the same bits here)
and ``aux`` within 1e-6 of its size (its float32 sums over the groups
add in another order: measured 1.8e-7 with 40 experts). Cases: no drops
(the reduced ``capacity_factor`` 8.0), drops (``capacity_factor`` 0.5
and 21 tokens, not a multiple of the group of 16), granite's 40 experts
top-8 with drops,
and ties: a zero router (every probability equal) and a router with
duplicated columns (pairs of equal probabilities), where ``jax.lax.top_k``
takes the lower expert index first.

The whole models (granite-moe-3b-a800m, mixtral-8x7b, jamba-v0.1-52b) are
held as ``tests/torch_lm_reference.py`` says: against ``repro`` without
XLA's excess precision (measured: granite and mixtral bitwise; jamba, 16
layers, 0.0046 and 0.0048 of the scale in prefill and decode logits,
where a matmul's accumulation order moves a bfloat16 value by one rounding
now and then; no near tie; the greedy tokens equal) and against its
compiled engine (as close as ``repro``'s own run without excess precision
is; measured, prefill and decode logits: 0.022 and 0.011 of the scale for
granite, 0.012 and 0.0068 for mixtral, 0.14 and 0.22 for jamba, the same
as ``repro``'s own; the compiled mamba mixer keeps float32 where ``repro``
without excess precision and the port round to bfloat16, and its greedy
tokens differ from ``repro``'s own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.moe as j_moe  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402

OUT_TOL = 2.0 ** -8
AUX_TOL = 1e-6
MODELS = ("granite-moe-3b-a800m", "mixtral-8x7b", "jamba-v0.1-52b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {    # name: (config changes, (B, S), router: random | zero | pairs)
    "no_drops": ({}, (2, 12), "random"),
    "drops": (dict(capacity_factor=0.5), (3, 7), "random"),
    "forty_top8": (dict(n_experts=40, top_k=8, moe_group_size=64,
                        capacity_factor=1.25), (2, 100), "random"),
    "zero_router": (dict(capacity_factor=1.0), (2, 12), "zero"),
    "zero_router_forty_top8": (dict(n_experts=40, top_k=8,
                                    capacity_factor=1.0), (2, 12), "zero"),
    "duplicated_columns": ({}, (2, 12), "pairs"),
}


def _weights(cfg, rng, router):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = dict(router=rng.standard_normal((d, e)) / np.sqrt(d),
             wi_gate=rng.standard_normal((e, d, f)) / np.sqrt(e),
             wi_up=rng.standard_normal((e, d, f)) / np.sqrt(e),
             wo=rng.standard_normal((e, f, d)) / np.sqrt(e))
    if router == "zero":
        w["router"][:] = 0.0
    elif router == "pairs":      # experts 2j and 2j + 1 always tie
        w["router"][:, 1::2] = w["router"][:, 0::2]
    return {k: v.astype(np.float32) for k, v in w.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def routed(request):
    """Per case: ``repro``'s ``moe_apply`` with its top-k and its
    einsums recorded, and the port's ``route`` and ``moe_apply``."""
    change, (b, s), router = CASES[request.param]
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                              **change)
    ref_cfg = dataclasses.replace(j_reduced_config("granite-moe-3b-a800m"),
                                  **change)
    rng = np.random.default_rng(len(request.param))
    w = _weights(cfg, rng, router)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    top, einsums = [], []
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def recorded_top_k(a, k):
        vals, idx = top_k(a, k)
        top.append(np.asarray(idx))
        return vals, idx

    def recorded_einsum(*a, **k):
        out = einsum(*a, **k)
        einsums.append(np.asarray(out, np.float32))
        return out

    patched = pytest.MonkeyPatch()
    patched.setattr(jax.lax, "top_k", recorded_top_k)
    patched.setattr(jnp, "einsum", recorded_einsum)
    try:
        want, want_aux = j_moe.moe_apply(
            {k: jnp.asarray(v) for k, v in w.items()},
            jnp.asarray(x, jnp.bfloat16), ref_cfg)
    finally:
        patched.undo()
    mod = t_moe.MoE(cfg, torch.device("cpu"))
    for k, v in w.items():
        getattr(mod, k).data.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).bfloat16()
    got, aux = t_moe.moe_apply(mod, xt, cfg)
    return dict(case=request.param, cfg=cfg, r=t_moe.route(mod, xt, cfg),
                experts=top[0], dispatch=einsums[1], combine=einsums[2],
                want=(want, want_aux), got=(got, aux), tokens=b * s)


def test_chosen_experts_are_repros(routed):
    r = routed["r"]
    np.testing.assert_array_equal(r.experts.numpy(), routed["experts"])
    if CASES[routed["case"]][2] == "zero":      # every probability ties
        k = routed["cfg"].top_k
        assert (r.experts == torch.arange(k)).all()


def test_slots_and_drops_are_repros(routed):
    """The dispatch tensor, (group, token, expert, slot), equal exactly:
    each kept (token, choice) in its slot, each dropped one nowhere."""
    r, cfg = routed["r"], routed["cfg"]
    dispatch = r.dispatch.float().numpy()
    np.testing.assert_array_equal(dispatch, routed["dispatch"])
    np.testing.assert_array_equal(r.combine.float().numpy(),
                                  routed["combine"])
    # the port's own account of its slots and drops agrees with it
    cap = t_moe.capacity(r.valid.shape[1], cfg)
    real = (r.valid[..., None] > 0).numpy()
    kept = (r.slots < cap).numpy() & real
    held = np.take_along_axis(dispatch.sum(-1), r.experts.numpy(), -1) > 0
    np.testing.assert_array_equal(held, kept)
    slot = np.argmax(np.take_along_axis(
        dispatch, r.experts.numpy()[..., None].repeat(dispatch.shape[-1],
                                                      -1), 2), -1)
    np.testing.assert_array_equal(slot[held], r.slots.numpy()[held])
    dropped = int((~kept & real).sum())
    if routed["case"] in ("drops", "forty_top8", "zero_router",
                          "zero_router_forty_top8"):
        assert dropped > 0, routed["case"]
    if routed["case"] == "no_drops":
        assert dropped == 0


def test_moe_output_and_aux_match_repro(routed):
    (want, want_aux), (got, aux) = routed["want"], routed["got"]
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    want = np.asarray(want, np.float32)
    err = np.max(np.abs(got.float().numpy() - want))
    assert err <= OUT_TOL * np.max(np.abs(want)), err
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL * max(
        1.0, abs(float(want_aux)))


def test_top_k_breaks_ties_by_the_lower_index():
    """40 equal probabilities, k = 8: ``jax.lax.top_k``'s experts 0-7
    (``torch.topk`` gives others)."""
    probs = np.full((3, 40), 1 / 40, np.float32)
    probs[1, [3, 17, 30]] = 0.5
    vals, idx = t_moe.top_k(torch.from_numpy(probs), 8)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


# ---------------------------------------------------------------------------
# the whole models


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    params = {arch: lm_ref.numpy_params(arch) for arch in MODELS}
    ref = lm_ref.Reference(MODELS, params, tmp_path_factory.mktemp("moe"))
    yield params, ref
    ref.proc.kill()
    ref.proc.wait()


@pytest.fixture(scope="module", params=MODELS)
def served(request, references):
    params, ref = references
    return lm_ref.serve_both(request.param, params[request.param], ref)


def test_model_matches_repro(served):
    lm_ref.check_model(served)
    assert served["routes"], served["arch"]


def test_model_is_as_close_to_compiled_repro_as_repro_is(served):
    lm_ref.check_compiled(served)


def test_follow_routing_takes_a_near_tie_and_refuses_more():
    """``follow_routing`` takes the recorded experts where this run's
    differ at a near tie, raises where the probabilities drift further,
    and raises when the runs make different numbers of calls."""
    cfg = reduced_config("granite-moe-3b-a800m")
    rng = np.random.default_rng(7)
    mod = t_moe.MoE(cfg, torch.device("cpu"))
    for k, v in _weights(cfg, rng, "random").items():
        getattr(mod, k).data.copy_(torch.from_numpy(v))
    x = torch.from_numpy(rng.standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)).bfloat16()
    log = []
    with t_moe.record_routing(log):
        want, _ = t_moe.moe_apply(mod, x, cfg)
    probs, experts = log[0]
    swapped = experts.clone()
    swapped[0, 3] = experts[0, 3].flip(-1)       # a tie at one token
    with t_moe.follow_routing([(probs, swapped)], 2.0 ** -7) as ties:
        r = t_moe.route(mod, x, cfg)
    assert [(t["group"], t["token"]) for t in ties] == [(0, 3)]
    assert torch.equal(r.experts, swapped)
    far = probs.clone()
    far[0, 3] += 0.1
    with pytest.raises(t_moe.RoutingMismatch, match="group 0, token 3"):
        with t_moe.follow_routing([(far, swapped)], 2.0 ** -7):
            t_moe.route(mod, x, cfg)
    with pytest.raises(t_moe.RoutingMismatch, match="call 1 was not made"):
        with t_moe.follow_routing(log * 2, 2.0 ** -7):
            t_moe.route(mod, x, cfg)
    with t_moe.follow_routing(log, 0.0) as ties:
        got, _ = t_moe.moe_apply(mod, x, cfg)
    assert not ties and torch.equal(got, want)
