"""The dry run and the hill climb (``repro_torch.launch.dryrun``,
``hillclimb``, ``hlo_cost``, ``roofline``; ``models.spec``'s logical axes,
``models.runtime``, ``train.state_specs``; the configs' shapes) against
``repro``.

Held exactly: the shapes and their applicability, every parameter's
logical axes and partition spec on both production meshes, the parameter
counts and estimates, per-device state bytes, ``state_specs``, the cost
tables. The product FLOPs of reduced cells against ``repro``'s compiled
HLO (``tests/torch_dryrun_reference.py``, in its own process, as
``repro.launch.dryrun`` forces the XLA host devices at import), with the
gaps named product by product:

* prefill: ``repro`` unembeds all S positions and keeps the last; the
  port unembeds the last (``2 * b * (S - 1) * d * V / tp``);
* a MoE train step: torch's recompute runs each MoE layer's combine
  product (its output feeds nothing the backward reads, but ops after it
  save tensors), which XLA removes (one ``(g, t, e*c) x (g, e*c, d)``
  product a layer a microbatch);
* on the 2×2 mesh the port's rule leaves the k/v projections whole on
  every ``model`` rank (``kv_heads -> None``) where XLA's partitioner
  splits them along the attention's heads and runs the MLP's input
  products whole instead: the train step is within 10%; the recurrent
  mixers (jamba's mamba, xlstm's mLSTM and sLSTM) are within 1%; a MoE
  prefill within 10%: the rule runs the dispatch product (the one-hot
  dispatch against the tokens) whole, XLA splits it along the experts,
  which it propagates back from the expert weights.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.launch import hlo_text as r_hlo_text
from repro.models import build_model as r_build_model
from repro.models import spec as r_spec
from repro.train import train_step as r_train_step

from repro_torch import configs as t_configs
from repro_torch.configs import ShapeConfig, reduced_config
from repro_torch.interop import _reference_leaf
from repro_torch.launch import dryrun, hillclimb, hlo_text, roofline
from repro_torch.launch.mesh import LogicalMesh, make_production_mesh
from repro_torch.models import new_model, runtime
from repro_torch.models import spec as t_spec
from repro_torch.train import state_specs

ROOT = Path(__file__).resolve().parents[1]
REPRO_RECORDS = ROOT / "artifacts" / "dryrun"   # repro's tests read it
ARCHS = list(r_configs.ARCHS)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

# reduced cells against repro's compiled HLO: name, arch, kind, mesh,
# batch, seq, microbatches, the bound on |port - named gaps - repro| /
# repro (on one device the named gaps are the whole gap)
CELLS = [
    ("stablelm prefill", "stablelm-1.6b", "prefill", [1, 1], 8, 64, 1, .01),
    ("stablelm decode", "stablelm-1.6b", "decode", [1, 1], 8, 64, 1, .01),
    ("stablelm train", "stablelm-1.6b", "train", [1, 1], 8, 64, 2, .02),
    ("granite prefill", "granite-moe-3b-a800m", "prefill", [1, 1], 8, 64, 1,
     .01),
    ("granite decode", "granite-moe-3b-a800m", "decode", [1, 1], 8, 64, 1,
     .01),
    ("granite train", "granite-moe-3b-a800m", "train", [1, 1], 8, 64, 2, .02),
    ("stablelm prefill 2x2", "stablelm-1.6b", "prefill", [2, 2], 8, 64, 1,
     .05),
    ("stablelm train 2x2", "stablelm-1.6b", "train", [2, 2], 8, 64, 2, .10),
    ("jamba prefill 2x2", "jamba-v0.1-52b", "prefill", [2, 2], 8, 64, 1, .01),
    ("xlstm prefill 2x2", "xlstm-125m", "prefill", [2, 2], 8, 64, 1, .01),
    ("granite prefill 2x2", "granite-moe-3b-a800m", "prefill", [2, 2], 8, 64,
     1, .10),
]


class _Reference:
    """``torch_dryrun_reference.py`` started once for the module, read
    when a test first needs it."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dryrun_reference.py"),
             json.dumps([list(c[:7]) for c in CELLS])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self._out = None

    def result(self) -> dict:
        if self._out is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err[-4000:]
            self._out = json.loads(out.strip().splitlines()[-1])
        return self._out


@pytest.fixture(scope="module", autouse=True)
def reference():
    ref = _Reference()
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _abstract(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names)


def _ref_specs(arch):
    return _leaves(r_build_model(r_configs.get_config(arch)).param_specs())


# ---------------------------------------------------------------------------
# shapes, counts, logical axes, partition specs

def test_shapes_equal_the_reference():
    assert list(t_configs.SHAPES) == list(r_configs.SHAPES)
    for name, shape in t_configs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            r_configs.SHAPES[name])


@pytest.mark.parametrize("shape", list(r_configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable(arch, shape):
    assert t_configs.shape_applicable(
        t_configs.get_config(arch), t_configs.SHAPES[shape]) == \
        r_base.shape_applicable(r_configs.get_config(arch),
                                r_configs.SHAPES[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_estimates(arch):
    cfg, rcfg = t_configs.get_config(arch), r_configs.get_config(arch)
    model = new_model(cfg, device="meta")
    assert t_spec.count_params(model) == r_spec.count_params(
        r_build_model(rcfg).param_specs())
    assert cfg.param_count_estimate() == rcfg.param_count_estimate()
    assert cfg.active_param_count_estimate() == \
        rcfg.active_param_count_estimate()


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_and_partition_specs(arch):
    """Every parameter's logical axes are the reference leaf's (a stacked
    leaf without its ``layers`` entry), and its partition spec on both
    production meshes under the arch's rules is the reference's."""
    cfg = t_configs.get_config(arch)
    model = new_model(cfg, device="meta")
    logical = t_spec.param_logical(model)
    ref = _ref_specs(arch)
    rules = dryrun.rules_for(arch)
    r_rules = r_spec.resolve_rules(dryrun.ARCH_RULES.get(arch, {}))
    assert rules == r_rules
    seen = set()
    for kind in MESHES:
        mesh, abstract = make_production_mesh(
            multi_pod=kind == "multi"), _abstract(kind)
        specs = t_spec.tree_pspecs(model, mesh, rules)
        for name, p in model.named_parameters():
            path, index, _ = _reference_leaf(name, cfg)
            leaf = ref[path]
            r_logical = leaf.logical[1:] if index is not None \
                else leaf.logical
            assert logical[name] == tuple(r_logical), name
            r_pspec = tuple(r_spec.partition_spec(
                leaf.logical, leaf.shape, abstract, r_rules))
            if index is not None:
                r_pspec = r_pspec[1:]
            r_pspec += (None,) * (p.ndim - len(r_pspec))
            assert specs[name] == r_pspec, (kind, name)
            seen.add(path)
    assert seen == set(ref) or cfg.n_groups == 0


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_per_device(arch, kind):
    """The train state's bytes on one device, from the port's specs,
    equal the shard shapes of ``repro``'s ``state_specs`` on the
    abstract mesh; ``state_specs``' shapes and dtypes are the
    reference's, unstacked."""
    cfg = t_configs.get_config(arch)
    model = new_model(cfg, device="meta", param_dtype=torch.float32)
    state = state_specs(model)
    rules = dryrun.rules_for(arch)
    mesh = make_production_mesh(multi_pod=kind == "multi")
    logical = t_spec.param_logical(model)
    port = sum(dryrun.state_bytes(tree, logical, mesh, rules) for tree in
               (state.params, state.opt.mu, state.opt.nu)) + 4
    abstract = _abstract(kind)
    r_rules = r_spec.resolve_rules(dryrun.ARCH_RULES.get(arch, {}))
    r_state = r_train_step.state_specs(r_build_model(r_configs.get_config(
        arch)))
    ref = 0
    for leaf in jax.tree.leaves(r_state, is_leaf=r_spec.is_spec):
        pspec = r_spec.partition_spec(leaf.logical, leaf.shape, abstract,
                                      r_rules)
        div = [1] * len(leaf.shape)
        for i, ax in enumerate(pspec):
            for a in ((ax,) if isinstance(ax, str) else ax or ()):
                div[i] *= abstract.shape[a]
        ref += math.prod(n // d for n, d in zip(leaf.shape, div)) * \
            np.dtype(leaf.dtype).itemsize
    assert port == ref
    ref_leaves = _leaves(r_state.params)
    for tree in (state.params, state.opt.mu, state.opt.nu):
        for name, t in tree.items():
            path, index, _ = _reference_leaf(name, cfg)
            shape = ref_leaves[path].shape[1 if index is not None else 0:]
            assert (tuple(t.shape), t.dtype, t.device.type) == (
                tuple(shape), torch.float32, "meta")
    assert (state.opt.step.shape, state.opt.step.dtype) == \
        ((), torch.int32)


def test_cost_tables_equal_the_reference():
    assert hlo_text.DTYPE_BYTES == r_hlo_text.DTYPE_BYTES
    assert hlo_text.COLLECTIVES == r_hlo_text.COLLECTIVES
    for kind in hlo_text.COLLECTIVES:
        for nbytes in (0, 1, 4096, 3.5e9):
            for n in (1, 2, 3, 16, 256):
                assert hlo_text.ring_wire_bytes(kind, nbytes, n) == \
                    r_hlo_text.ring_wire_bytes(kind, nbytes, n)


# ---------------------------------------------------------------------------
# the runtime context

def test_runtime_without_a_context_returns_its_argument():
    x = torch.ones(2, 3)
    assert runtime.current() is None
    assert runtime.constrain(x, ("batch", None)) is x
    assert runtime.gather_weight(x, ("embed", "ff")) is x
    assert runtime.scan_unroll(7) == 1


def test_sharding_ctx_nests_and_restores():
    mesh = LogicalMesh(("data", "model"), (2, 2))
    outer = t_spec.resolve_rules({"_gather_weights": True})
    x = torch.ones(4, 8)
    with runtime.sharding_ctx(mesh, outer) as a:
        assert runtime.gather_weight(x, ("embed", "ff")) is x
        assert a.records[-1].spec == ("data", "model")
        assert a.records[-1].gathered == (None, "model")
        with runtime.sharding_ctx(mesh, t_spec.resolve_rules(),
                                  unroll_scans=True) as b:
            assert runtime.current() is b
            assert runtime.scan_unroll(5) == 5
            assert runtime.gather_weight(x, ("embed", "ff")) is x
            assert runtime.constrain(x, ("batch", "vocab")) is x
            assert b.records[-1].spec == ("data", "model")
            assert len(b.records) == 1          # no gather without the lever
        assert runtime.current() is a
    assert runtime.current() is None


def test_a_context_keeps_logits_and_a_train_step_bitwise():
    from repro_torch.data import pipeline_for
    from repro_torch.train import AdamW, constant_lr, init_state, \
        make_train_step
    cfg = reduced_config("stablelm-1.6b")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    batch = pipeline_for(cfg, seq_len=16, global_batch=2, seed=0,
                         device="cpu").batch(0)
    mesh = LogicalMesh(("data", "model"), (2, 2))
    rules = dryrun.rules_for("internvl2-76b", {"_gather_weights": True})
    runs = []
    for ctx in (None, rules):
        model = new_model(cfg, device="cpu").init_params(0)
        train = new_model(cfg, device="cpu", param_dtype=torch.float32)
        opt = AdamW(learning_rate=constant_lr(1e-3))
        state = init_state(train, opt, 0)
        step = make_train_step(train, opt, microbatches=2)
        with (runtime.sharding_ctx(mesh, ctx) if ctx else
              _null()) as c:
            logits, _ = model.prefill(tokens, 16)
            state, metrics = step(state, batch)
            if c is not None:
                assert c.records          # the layouts were named
        runs.append((logits, metrics["loss"], {
            k: v.detach().clone() for k, v in state.params.items()}))
    (l0, loss0, p0), (l1, loss1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(loss0, loss1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_product_flops_split_over_the_model_axis():
    """kv_heads -> None: the k/v projections run whole on each ``model``
    rank; the query projection, the attention, the MLP and the output
    head split."""
    cfg, one = _port_cell("stablelm-1.6b", "prefill", [1, 1], 4, 32, 1)
    _, two = _port_cell("stablelm-1.6b", "prefill", [1, 2], 4, 32, 1)
    d, tokens = cfg.d_model, 4 * 32
    kv = 2 * 2.0 * tokens * d * cfg.n_kv_heads * cfg.d_head * cfg.n_layers
    assert two["cost_analysis"]["product_flops"] == pytest.approx(
        (one["cost_analysis"]["product_flops"] - kv) / 2 + kv)
    assert two["cost_analysis"]["attention_flops"] == \
        one["cost_analysis"]["attention_flops"] / 2
    assert one["cost_analysis"]["attention_useful_flops"] == \
        one["cost_analysis"]["attention_flops"] * 33 / 64


# ---------------------------------------------------------------------------
# records and levers

R_OK_KEYS = {"cell", "status", "arch", "shape", "mesh", "n_devices", "kind",
             "params_total", "params_active", "tokens_global",
             "model_flops_per_device", "lower_s", "compile_s", "memory",
             "cost_analysis", "roofline"}
R_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes", "peak_est_bytes"}


def test_run_cell_records(tmp_path):
    from repro.launch import roofline as r_roofline
    existed = REPRO_RECORDS.exists()
    ok = dryrun.run_cell("xlstm-125m", "long_500k", "single",
                         out_dir=tmp_path, verbose=False)
    skipped = dryrun.run_cell("stablelm-1.6b", "long_500k", "multi",
                              out_dir=tmp_path, verbose=False)
    assert ok["status"] == "ok", ok.get("traceback")
    assert R_OK_KEYS <= set(ok)
    assert R_MEMORY_KEYS <= set(ok["memory"])
    assert {"flops", "bytes accessed", "transcendentals"} <= set(
        ok["cost_analysis"])
    assert set(ok["roofline"]) == {
        f.name for f in dataclasses.fields(r_roofline.RooflineTerms)}
    assert ok["memory"]["peak_is_estimate"] is True
    assert ok["roofline"]["hardware"] == "cuda-h100-tc"
    assert skipped == {"cell": "single_stablelm-1.6b_long_500k".replace(
        "single", "multi"), "status": "skipped",
        "reason": r_base.shape_applicable(
            r_configs.get_config("stablelm-1.6b"),
            r_configs.SHAPES["long_500k"])[1]}
    assert json.loads((tmp_path / f"{ok['cell']}.json").read_text()) == \
        json.loads(json.dumps(ok, default=str))
    assert REPRO_RECORDS.exists() == existed     # nothing written there


def test_cell1_levers_move_the_collectives():
    """The hill climb's cell-1 levers at a reduced internvl2 on a 2×2
    mesh: explicit weight gathering (bf16 gathers) and dropping sequence
    parallelism each change the collective bytes."""
    cfg = reduced_config("internvl2-76b")
    mesh = LogicalMesh(("data", "model"), (2, 2))
    shape = ShapeConfig("cell", 32, 8, "train")
    wire = {}
    for name in ("baseline_sp", "gather_weights", "no_sp_gather"):
        rules, _ = hillclimb.CELL1_VARIANTS[name]
        rec = dryrun.measure("internvl2-76b", "cell", mesh, rules, 2,
                             cfg=cfg, shape=shape)
        wire[name] = rec["roofline"]["wire_bytes_per_device"]
    assert wire["gather_weights"] < wire["baseline_sp"]
    assert wire["no_sp_gather"] < wire["gather_weights"]


def test_cell3_levers(tmp_path):
    existed = REPRO_RECORDS.exists()
    recs = hillclimb.cell3(["baseline_fp32", "bf16_values",
                            "blocked_crossing"], out_dir=tmp_path)
    assert recs["bf16_values"]["roofline"]["bytes_per_device"] < \
        recs["baseline_fp32"]["roofline"]["bytes_per_device"]
    assert recs["bf16_values"]["values_bytes"] * 2 == \
        recs["baseline_fp32"]["values_bytes"]
    assert recs["blocked_crossing"]["activation_peak_est_bytes"] < \
        recs["bf16_values"]["activation_peak_est_bytes"]
    wire = recs["baseline_fp32"]["roofline"]["collective_detail"]
    assert set(wire) == {"all-reduce", "all-gather"}
    assert (tmp_path / "cell3_baseline_fp32.json").exists()
    assert REPRO_RECORDS.exists() == existed


def test_axis_links():
    hw = roofline.H100_TENSOR_CORES
    prod = make_production_mesh()
    assert roofline.axis_bandwidth(prod, "model", hw) == \
        roofline.INTER_NODE_BW
    assert roofline.axis_bandwidth(prod, "data", hw) == \
        roofline.INTER_NODE_BW
    small = LogicalMesh(("data", "model"), (2, 2))
    assert roofline.axis_bandwidth(small, ("data", "model"), hw) == \
        hw.ici_bw
    assert roofline.HARDWARE["cuda-h100"].peak_flops == 67e12
    assert (hw.name, hw.peak_flops) == ("cuda-h100-tc", 989e12)


# ---------------------------------------------------------------------------
# the cost count itself

def test_analyze_counts_products_bytes_and_layouts():
    """A product's FLOPs, each op's operand and result bytes (a view
    moves none), and the model axis: the weight's split divides the
    product, a contraction over it is all-reduced."""
    from repro_torch.launch import hlo_cost
    meta = torch.device("meta")
    x = torch.empty((8, 64), device=meta)
    w1 = torch.empty((64, 128), device=meta)
    w2 = torch.empty((128, 64), device=meta)
    mesh = LogicalMesh(("data", "model"), (1, 4))
    rules = t_spec.resolve_rules()
    for w, logical in ((w1, ("embed", "ff")), (w2, ("ff", "embed"))):
        hlo_cost.set_shard(w, hlo_cost.state_shard(t_spec.partition_spec(
            logical, tuple(w.shape), mesh, rules), mesh, weight=True))

    def mlp():
        h = torch.tanh(x.view(8, 64) @ w1)
        return h @ w2

    cost = hlo_cost.analyze(mlp, mesh=mesh, rules=rules)
    assert cost.product_flops == 2 * 8 * 64 * 128 / 4 + 2 * 8 * 128 * 64 / 4
    f32 = 4
    assert cost.bytes == f32 * (8 * 64 + 64 * 128 / 4 + 8 * 128 / 4   # mm
                                + 2 * 8 * 128 / 4                    # tanh
                                + 8 * 128 / 4 + 128 * 64 / 4 + 8 * 64)
    assert cost.coll_by_kind == {"all-reduce": 2 * 8 * 64 * f32 * 3 / 4}
    assert cost.transcendentals == 8 * 128 / 4


def test_memoised_count_equals_a_fresh_count(monkeypatch):
    """The count memoises each op by its arguments' layouts (and AdamW's
    per-leaf work through ``kernels.meta.repeatable``): a count without
    either memo gives the same cost and peak."""
    from repro_torch.launch import hlo_cost
    mesh = LogicalMesh(("data", "model"), (2, 2))
    shape = ShapeConfig("cell", 32, 8, "train")

    def count():
        cell = dryrun.build_cell(
            "granite-moe-3b-a800m", "cell", mesh, None, 2,
            cfg=reduced_config("granite-moe-3b-a800m"), shape=shape)
        return dryrun.count_cell(cell, mesh,
                                 dryrun.rules_for("granite-moe-3b-a800m"))

    memo = count()
    dispatch = hlo_cost.CostCounter.__torch_dispatch__

    def fresh(self, func, types, args=(), kwargs=None):
        self._memo.clear()
        return dispatch(self, func, types, args, kwargs)
    monkeypatch.setattr(hlo_cost.CostCounter, "__torch_dispatch__", fresh)
    monkeypatch.setattr(hlo_cost.CostCounter, "repeatable",
                        lambda self, fn, args: fn(*args))
    assert count() == memo


# ---------------------------------------------------------------------------
# costs against repro's compiled HLO (last: the reference's process
# runs while the tests above do)

def _port_cell(arch, kind, mesh_shape, b, s, mb):
    cfg = reduced_config(arch)
    mesh = LogicalMesh(("data", "model"), tuple(mesh_shape))
    rec = dryrun.measure(arch, "cell", mesh, None, mb, cfg=cfg,
                         shape=ShapeConfig("cell", s, b, kind))
    return cfg, rec


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_product_flops_against_the_reference(cell, reference):
    name, arch, kind, mesh_shape, b, s, mb, tol = cell
    cfg, rec = _port_cell(arch, kind, mesh_shape, b, s, mb)
    port = rec["cost_analysis"]["product_flops"]
    tp = mesh_shape[1]
    named = 0.0
    if kind == "prefill":
        named -= 2.0 * rec["local_batch"] * (s - 1) * cfg.d_model \
            * cfg.padded_vocab / tp
    if kind == "train" and cfg.n_experts:
        # the recompute's combine product, a MoE layer a microbatch
        tokens = rec["local_batch"] // mb * s
        g_size = min(cfg.moe_group_size, tokens)
        cap = max(int(g_size * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts), cfg.top_k)
        layers = sum(ls.moe for ls in cfg.layers)
        named += mb * layers * 2.0 * tokens * cfg.n_experts * cap \
            * cfg.d_model
    ref = reference.result()["cells"][name]["product_flops"]
    assert abs(port - named - ref) <= tol * ref, (port, named, ref)
    if mesh_shape == [1, 1]:
        assert port - named == ref      # the gaps named are the whole gap


def test_rules_and_microbatches_equal_the_reference(reference):
    ref = reference.result()
    assert {k: {r: (list(v) if isinstance(v, tuple) else v)
                for r, v in d.items()}
            for k, d in dryrun.ARCH_RULES.items()} == ref["arch_rules"]
    assert dryrun.ARCH_MICROBATCHES == ref["arch_microbatches"]
