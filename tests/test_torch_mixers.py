"""The port's recurrent mixers and its four MoE and recurrent models against
``repro``'s, on the CPU, with ``repro``'s parameters carried across
(``interop.lm_params_from_reference``) at ``reduced_config``.

Mixers (``repro`` run eagerly, op by op outside its chunk scans), on the
same bfloat16 inputs from seeded numpy, over more than one chunk:

* outputs (bfloat16) within ``OUT_TOL`` of their scale, ``max|port -
  repro| / max|repro|``: one bfloat16 ulp at the scale (2^-7). Measured:
  0.0008 (mamba, S=2,048: two chunks of 1,024), 0.0048 (mLSTM, S=512: two
  chunks of 256: its cumulative log forget gates add in another order),
  0 (sLSTM); the decode steps after them 0;
* states (float32) within ``STATE_TOL`` of their scale. Measured: 1.2e-7
  (mamba: the doubling scan adds in another order than
  ``lax.associative_scan``), 2e-5 (mLSTM's m), 2e-7 (sLSTM).

The whole xlstm-125m is held as ``tests/torch_lm_reference.py`` says:
against ``repro`` without XLA's excess precision (measured: 0.013 and
0.015 of the scale in prefill and decode logits, where a matmul's
accumulation order moves a bfloat16 value by one rounding now and then;
the greedy tokens equal) and against its compiled engine (as close as
``repro``'s own run without excess precision is; measured 0.079 and 0.15
against ``repro``'s own 0.076 and 0.15: the compiled mLSTM and sLSTM keep
float32 where ``repro`` without excess precision and the port round to
bfloat16, and its greedy tokens differ from ``repro``'s own). The whole
jamba-v0.1-52b is in ``tests/test_torch_moe.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.spec import count_params  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models import mamba as t_mamba  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402

OUT_TOL = 2.0 ** -7
STATE_TOL = 1e-4
MODELS = ("xlstm-125m",)
ALL_MODELS = ("granite-moe-3b-a800m", "mixtral-8x7b", "jamba-v0.1-52b",
              "xlstm-125m")
B, S, MAX_LEN = lm_ref.B, lm_ref.S, lm_ref.MAX_LEN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_rel = lm_ref.rel


def _pair(arch):
    cfg = reduced_config(arch)
    params = lm_ref.numpy_params(arch)
    port = interop.lm_params_from_reference(params, cfg, device="cpu")
    return cfg, params, port


# ---------------------------------------------------------------------------
# the mixers, one layer each, over more than one chunk


MIXERS = {   # kind: (arch, layer, prompt length, repro's apply, its step)
    "mamba": ("jamba-v0.1-52b", 0, 2048, j_mamba.mamba_apply,
              j_mamba.mamba_step, t_mamba.mamba_apply, t_mamba.mamba_step),
    "mlstm": ("xlstm-125m", 0, 512, j_xlstm.mlstm_apply, j_xlstm.mlstm_step,
              t_xlstm.mlstm_apply, t_xlstm.mlstm_step),
    "slstm": ("xlstm-125m", 5, 128, j_xlstm.slstm_apply, j_xlstm.slstm_step,
              t_xlstm.slstm_apply, t_xlstm.slstm_step),
}


@pytest.fixture(scope="module", params=sorted(MIXERS))
def mixer(request):
    """Per mixer: ``repro``'s and the port's prefill over s tokens with
    its state, and one decode step from that state."""
    kind = request.param
    arch, layer, s, j_apply, j_step, t_apply, t_step = MIXERS[kind]
    cfg, params, port = _pair(arch)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                     params["groups"])[f"sub{layer}"][kind]
    tp = getattr(port.blocks[layer], kind)
    x = np.random.default_rng(3).standard_normal(
        (B, s + 1, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    ref_cfg = j_reduced_config(arch)
    want, want_state = j_apply(p, xj[:, :s], ref_cfg, return_state=True)
    want_step, want_next = j_step(p, xj[:, s:], ref_cfg, want_state)
    want_longer, _ = j_apply(p, xj, ref_cfg)
    got, state = t_apply(tp, xt[:, :s], cfg, return_state=True)
    got_step, nxt = t_step(tp, xt[:, s:], cfg, state)
    longer, _ = t_apply(tp, xt, cfg)
    return dict(kind=kind, cfg=cfg, tp=tp, xt=xt,
                want=(want, want_state, want_step, want_next),
                got=(got, state, got_step, nxt),
                longers=(longer, want_longer))


def test_mixer_prefill_matches_repro(mixer):
    want, want_state, _, _ = mixer["want"]
    got, state, _, _ = mixer["got"]
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= OUT_TOL, mixer["kind"]
    assert type(state).__name__ == type(want_state).__name__
    for name, a, b in zip(state._fields, state, want_state):
        assert a.dtype == torch.float32, name
        assert tuple(a.shape) == tuple(b.shape), name
        assert _rel(a, b) <= STATE_TOL, (mixer["kind"], name)


def test_mixer_decode_step_matches_repro(mixer):
    _, _, want_step, want_next = mixer["want"]
    _, _, got_step, nxt = mixer["got"]
    assert _rel(got_step, want_step) <= OUT_TOL, mixer["kind"]
    for name, a, b in zip(nxt._fields, nxt, want_next):
        assert _rel(a, b) <= STATE_TOL, (mixer["kind"], name)


def test_prefill_then_decode_is_a_longer_prefill(mixer):
    """The decode step after a prefill of s tokens gives the prefill of
    s + 1 tokens' last output as closely as ``repro``'s own two forms
    agree, within one bfloat16 ulp (the mLSTM's parallel form rounds
    its gate-weighted scores to bfloat16, its recurrent form does not:
    0.0052 of the scale in both packages)."""
    longer, want_longer = mixer["longers"]
    port = _rel(mixer["got"][2], longer[:, -1:].float().numpy())
    ref = _rel(mixer["want"][2], want_longer[:, -1:])
    assert port <= ref + OUT_TOL, (port, ref)


def test_slstm_ffn_matches_repro():
    cfg, params, port = _pair("xlstm-125m")
    p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                     params["groups"])["sub5"]["slstm"]
    x = np.random.default_rng(4).standard_normal(
        (B, 9, cfg.d_model)).astype(np.float32)
    want = j_xlstm.slstm_ffn(p, jnp.asarray(x, jnp.bfloat16))
    got = t_xlstm.slstm_ffn(port.blocks[5].slstm,
                            torch.from_numpy(x).bfloat16())
    assert _rel(got, want) <= OUT_TOL


def test_mamba_channel_slices_change_no_number(monkeypatch):
    """A chunk split over d_in channels (as at full width) gives the
    unsplit chunk's bits."""
    cfg, _, port = _pair("jamba-v0.1-52b")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 96, cfg.d_model)).astype(np.float32)).bfloat16()
    whole, state = t_mamba.mamba_apply(port.blocks[0].mamba, x, cfg, True)
    b, n = x.shape[0], cfg.mamba_d_state
    monkeypatch.setattr(t_mamba, "SCAN_ELEMENTS", b * 96 * n * 40)
    assert len(t_mamba.channel_slices(b, 96, 128, n)) == 4
    sliced, state2 = t_mamba.mamba_apply(port.blocks[0].mamba, x, cfg, True)
    assert torch.equal(whole, sliced)
    assert all(torch.equal(a, b) for a, b in zip(state, state2))


# ---------------------------------------------------------------------------
# whole models


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    params = {arch: lm_ref.numpy_params(arch) for arch in MODELS}
    ref = lm_ref.Reference(MODELS, params, tmp_path_factory.mktemp("mixers"))
    yield params, ref
    ref.proc.kill()
    ref.proc.wait()


@pytest.fixture(scope="module", params=MODELS)
def served(request, references):
    params, ref = references
    return lm_ref.serve_both(request.param, params[request.param], ref)


def test_model_matches_repro(served):
    lm_ref.check_model(served)
    assert bool(served["routes"]) == bool(served["cfg"].n_experts)


def test_model_is_as_close_to_compiled_repro_as_repro_is(served):
    lm_ref.check_compiled(served)


@pytest.mark.parametrize("arch", ALL_MODELS)
def test_prefill_decode_consistency(arch):
    """decode(pos=S) after prefill(S) ~= prefill(S+1)'s last position."""
    cfg = reduced_config(arch)
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1))).long()
    full, _ = model.prefill(toks, MAX_LEN)
    _, caches = model.prefill(toks[:, :S], MAX_LEN)
    step, _ = model.decode_step(caches, toks[:, S:], S)
    assert _rel(step, full.float().numpy()) < 0.15
    assert torch.isfinite(step.float()).all()


# ---------------------------------------------------------------------------
# parameters: the carry-over of each new subtree, the initialisers


@pytest.mark.parametrize("arch", ALL_MODELS)
def test_full_configs_build_with_the_references_parameters(arch):
    """At full width (on the meta device: no memory) the model holds as
    many parameters as ``repro``'s spec tree (mixtral-8x7b 46.7 billion,
    jamba-v0.1-52b 51.6 billion)."""
    model = Model(get_config(arch), device="meta")
    specs = j_build_model(j_get_config(arch)).param_specs()
    assert sum(p.numel() for p in model.parameters()) == count_params(specs)
    assert len(model.blocks) == get_config(arch).n_layers


@pytest.mark.parametrize("arch,layer,path", [
    ("granite-moe-3b-a800m", 1, "moe/wi_gate"),
    ("mixtral-8x7b", 0, "moe/router"),
    ("jamba-v0.1-52b", 9, "mamba/a_log"),
    ("jamba-v0.1-52b", 11, "moe/wo"),
    ("xlstm-125m", 7, "mlstm/b_f"),
    ("xlstm-125m", 11, "slstm/r_z"),
])
def test_carry_over_of_each_subtree(arch, layer, path):
    """Layer ``layer`` holds the reference's stacked leaf of its group, in
    the dtype the reference reads it at (float32 ``a_log`` and gate
    biases, bfloat16 matmul weights); a misshapen leaf raises."""
    cfg = reduced_config(arch)
    params = lm_ref.numpy_params(arch)
    model = interop.lm_params_from_reference(params, cfg, device="cpu")
    width = len(cfg.pattern)
    sub, name = path.split("/")
    leaf = params["groups"][f"sub{layer % width}"][sub][name][layer // width]
    got = getattr(getattr(model.blocks[layer], sub), name)
    dtype = jnp.float32 if got.dtype == torch.float32 else jnp.bfloat16
    assert (got.dtype == torch.float32) == name.startswith(("a_log", "b_"))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnp.asarray(leaf, dtype), np.float32))
    wrong = jax.tree.map(lambda a: a, params)
    group = wrong["groups"][f"sub{layer % width}"][sub]
    group[name] = np.zeros(group[name].shape[:1] + (3,), np.float32)
    with pytest.raises(ValueError, match=f"{sub}/{name} has shape"):
        interop.lm_params_from_reference(wrong, cfg, device="cpu")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_carry_over_of_a_cut_shorter_than_one_pattern(arch):
    """Two layers of a pattern of 8 (jamba) or 6 (xlstm): no group, every
    layer in the tail; the reference's stacked groups are empty and carry
    nothing, and the cut model prefills as the reference's does."""
    cfg = dataclasses.replace(reduced_config(arch), n_layers=2)
    ref_cfg = dataclasses.replace(j_reduced_config(arch), n_layers=2)
    j_model = j_build_model(ref_cfg)
    params = lm_ref.numpy_params(arch, n_layers=2)
    assert cfg.n_groups == 0 and len(cfg.tail) == 2
    model = interop.lm_params_from_reference(params, cfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
    got, _ = model.prefill(torch.from_numpy(toks).long(), MAX_LEN)
    want, _ = jax.jit(lambda p, t: j_model.prefill(p, {"tokens": t},
                                                   MAX_LEN))(params, toks)
    assert _rel(got, want[:, -1:]) < lm_ref.MODEL_TOL


def test_init_params_of_the_new_layers():
    """The reference's initialisers and scales: ones for ``dt_bias``,
    ``a_log``, ``d_skip``, ``b_f``, the norms; zeros for ``conv_b`` and
    ``b_i``; std ``0.5 / sqrt(h)`` for sLSTM's ``r_g`` and ``1 /
    sqrt(e)`` for an (e, d, f) expert weight."""
    mamba = build_model(reduced_config("jamba-v0.1-52b"), device="cpu",
                        seed=1).blocks[1]
    for name in ("dt_bias", "a_log", "d_skip"):
        assert bool((getattr(mamba.mamba, name) == 1).all()), name
    assert not mamba.mamba.conv_b.any()
    assert mamba.mamba.a_log.dtype == torch.float32
    assert mamba.mamba.d_skip.dtype == torch.bfloat16
    e = reduced_config("jamba-v0.1-52b").n_experts
    assert abs(float(mamba.moe.wi_gate.float().std()) * e ** 0.5 - 1) < 0.05
    cfg = dataclasses.replace(reduced_config("xlstm-125m"), d_model=256)
    x = build_model(cfg, device="cpu", seed=1)
    ml, sl = x.blocks[0].mlstm, x.blocks[5].slstm
    assert bool((ml.b_f == 1).all()) and not ml.b_i.any()
    assert bool((ml.out_norm == 1).all()) and bool((sl.b_f == 1).all())
    assert not sl.b_z.any() and bool((sl.ff_norm == 1).all())
    h = cfg.n_heads
    assert abs(float(sl.r_z.float().std()) * h ** 0.5 / 0.5 - 1) < 0.05
    caches = x.init_cache(3, 20)
    assert type(caches[0]).__name__ == "MLSTMState"
    assert type(caches[5]).__name__ == "SLSTMState"
    assert all(t.dtype == torch.float32 and not t.any()
               for c in caches for t in c)
