"""The dry run: every (arch x shape x mesh) cell's per-device costs,
counted on the ``meta`` device (port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell on 512 fake XLA devices and reads
the partitioned HLO. The port builds each cell's model, state and inputs
on the ``meta`` device (nothing is allocated and no card is needed) and
runs the step once through its own entry points under
:class:`repro_torch.launch.hlo_cost.CostCounter`:

* ``train``: :func:`repro_torch.train.make_train_step` (the loss, the
  backward with the per-block recompute, the AdamW update) on
  :func:`repro_torch.train.state_specs`' float32 masters and moments;
* ``prefill``: ``model.prefill`` at ``max_len = seq_len``;
* ``decode``: ``model.decode_step`` on caches of ``seq_len`` positions at
  the last position.

The inputs are ``repro``'s ``batch_specs`` (tokens, labels, the stub
frontends' ``patch_embeds`` and ``frames``) at one data shard's batch:
the global batch over the mesh's batch axes (the rules' ``"batch"``), or
whole where they do not divide it, as the partition rules decide. The mesh
is logical (:func:`repro_torch.launch.mesh.make_production_mesh`).

**The per-device rule** (which axes split which products): the batch axes
split the batch; the ``model`` axis splits every product one of whose
operands it splits, following each tensor's split dim through the run
from the partition specs of the parameters and caches and the layouts the
model names (``runtime.constrain``); a product contracting over a split
dim is all-reduced; the FSDP axis (``embed -> data``) splits storage, and
each use of a parameter all-gathers it. The rule's every case is in
:mod:`repro_torch.launch.hlo_cost`'s docstring.

One record a cell, with ``repro``'s keys, goes to
``artifacts/dryrun_torch/<mesh>_<arch>_<shape>.json`` (never
``artifacts/dryrun/``, which ``repro``'s tests read): ``status`` ``ok``,
``skipped`` (``shape_applicable``'s reason) or ``error``; ``memory`` per
device: the state (parameters, moments, caches) and the batch exactly,
from the partition specs, and ``temp_bytes``, the counted run's peak of
live activation bytes, **an estimate** (``peak_is_estimate``);
``cost_analysis`` (``flops``, ``bytes accessed``, ``transcendentals``,
and the products' FLOPs apart) and ``roofline`` (the three terms under
:data:`~repro_torch.launch.roofline.H100_TENSOR_CORES`'s
data-sheet rates). ``lower_s`` is the seconds to build the cell on
``meta``, ``compile_s`` those of the counted run (nothing is compiled).

Run (CPU only, no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import (ARCHS, SHAPES, ArchConfig, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import new_model
from repro_torch.models import spec as spec_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import DecCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.xlstm import MLSTMState, SLSTMState
from repro_torch.train import AdamW, make_train_step, state_specs
from repro_torch.train.optimizer import warmup_cosine

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# Per-arch logical-rule overrides (repro's sharding design knobs)
ARCH_RULES: Dict[str, Dict[str, Any]] = {
    # 40 tiny experts: expert-parallel instead of ff tensor-parallel
    "granite-moe-3b-a800m": {"expert": "model", "ff": None},
    # sequence-parallel residual stream: the 80-layer remat carry stack
    # must shard over 'model'
    "internvl2-76b": {"act_seq": "model"},
    "internlm2-20b": {"act_seq": "model"},
}

# Per-arch microbatch counts for train_4k (memory lever; global batch 256)
ARCH_MICROBATCHES: Dict[str, int] = {
    "internvl2-76b": 8,
    "internlm2-20b": 4,
    "gemma3-12b": 8,
    "gemma3-4b": 4,
    "mixtral-8x7b": 8,
    "granite-moe-3b-a800m": 4,
    "jamba-v0.1-52b": 16,
    "stablelm-1.6b": 4,
    "xlstm-125m": 4,
    "whisper-small": 4,
}

# logical axes of each decode cache's fields (repro's cache specs)
_KV = ("batch", "kv_seq", "kv_heads", "head_dim")
CACHE_LOGICAL = {
    KVCache: {"k": _KV, "v": _KV},
    MambaState: {"ssm": ("batch", "inner", "state"),
                 "conv": ("batch", "conv", "inner")},
    MLSTMState: {"c": ("batch", "heads", "head_dim", None),
                 "n": ("batch", "heads", "head_dim"),
                 "m": ("batch", "heads"),
                 "conv": ("batch", "conv", "inner")},
    SLSTMState: {f: ("batch", "heads", "head_dim")
                 for f in SLSTMState._fields},
    DecCache: {"cross_k": ("batch", "frames", "kv_heads", "head_dim"),
               "cross_v": ("batch", "frames", "kv_heads", "head_dim")},
}


def rules_for(arch: str, overrides: Optional[Dict[str, Any]] = None):
    r = dict(ARCH_RULES.get(arch, {}))
    if overrides:
        r.update(overrides)
    return spec_lib.resolve_rules(r)


def batch_logical(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    """``repro``'s ``batch_specs``: each input's shape, dtype and logical
    axes."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32, ("batch", "seq"))}
    s_text = s - cfg.num_patches if cfg.num_patches else s
    out = {"tokens": ((b, s_text), torch.int32, ("batch", "seq"))}
    if shape.kind == "train":
        out["labels"] = ((b, s_text), torch.int32, ("batch", "seq"))
    if cfg.num_patches:
        out["patch_embeds"] = ((b, cfg.num_patches, cfg.d_model),
                               torch.bfloat16, ("batch", "seq", "embed"))
    if cfg.is_encdec:
        out["frames"] = ((b, cfg.encoder_frames, cfg.d_model),
                         torch.bfloat16, ("batch", "frames", "embed"))
    return out


def cache_items(caches):
    """``(field tensor, logical axes)`` of every cache tensor."""
    for cache in caches:
        if isinstance(cache, DecCache):
            yield from cache_items([cache.self_kv])
        for f, logical in CACHE_LOGICAL[type(cache)].items():
            yield getattr(cache, f), logical


def shard_bytes(t: torch.Tensor, logical, mesh, rules) -> int:
    """One device's bytes of ``t`` (its shard shape from its spec)."""
    spec = spec_lib.partition_spec(logical, tuple(t.shape), mesh, rules)
    return math.prod(spec_lib.shard_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()


def state_bytes(tensors: Dict[str, torch.Tensor], logical, mesh,
                rules) -> int:
    """Per-device bytes of named state (parameters or moments), exact
    from the partition specs."""
    return sum(shard_bytes(t, logical[name], mesh, rules)
               for name, t in tensors.items())


@dataclasses.dataclass
class Cell:
    """A cell ready to count: ``run()`` is one step on ``meta`` tensors;
    ``params`` its parameters (for the gradient hooks); the per-device
    state and batch bytes and the record's meta fields."""
    run: Callable[[], Any]
    params: Dict[str, torch.Tensor]
    meta: Dict[str, Any]
    state_bytes: int
    batch_bytes: int
    alias_bytes: int
    pod_grad_bytes: float = 0.0


def local_batch(shape: ShapeConfig, mesh, rules) -> int:
    """One data shard's batch: the global batch over the mesh axes the
    rules give ``"batch"``, or whole where they do not divide it."""
    spec = spec_lib.partition_spec(("batch",), (shape.global_batch,), mesh,
                                   rules)
    return spec_lib.shard_shape((shape.global_batch,), spec, mesh)[0]


def build_cell(arch: str, shape_name: str, mesh,
               rule_overrides: Optional[Dict[str, Any]] = None,
               microbatches: int = 1, *, cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """One cell's model, state and inputs on ``meta`` (``cfg`` and
    ``shape`` override the registry's, e.g. a reduced config)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rules = rules_for(arch, rule_overrides)
    meta_dev = torch.device("meta")
    train = shape.kind == "train"
    model = new_model(cfg, device=meta_dev,
                      param_dtype=torch.float32 if train else torch.bfloat16)
    logical = spec_lib.param_logical(model)
    params = dict(model.named_parameters())
    hlo_cost.tag_state(params, logical, mesh, rules)
    b_local = local_batch(shape, mesh, rules)
    batch, batch_bytes = {}, 0
    for name, (gshape, dtype, lg) in batch_logical(cfg, shape).items():
        full = torch.empty(gshape, dtype=dtype, device=meta_dev)
        batch_bytes += shard_bytes(full, lg, mesh, rules)
        batch[name] = torch.empty((b_local,) + gshape[1:], dtype=dtype,
                                  device=meta_dev)
    n_dev = mesh.size
    pod_grad = 0.0
    if train:
        specs = state_specs(model)
        for p in params.values():
            p.requires_grad_(True)
        hlo_cost.tag_state(specs.opt.mu, logical, mesh, rules)
        hlo_cost.tag_state(specs.opt.nu, logical, mesh, rules)
        master_bytes = state_bytes(specs.params, logical, mesh, rules)
        sbytes = (master_bytes
                  + state_bytes(specs.opt.mu, logical, mesh, rules)
                  + state_bytes(specs.opt.nu, logical, mesh, rules) + 4)
        # the model's own parameters are the masters; the step count is a
        # host scalar (the optimizer reads it on the host)
        from repro_torch.train import TrainState
        state = TrainState(params=params, opt=specs.opt._replace(
            step=torch.zeros((), dtype=torch.int32)))
        opt = AdamW(learning_rate=warmup_cosine(3e-4, 200, 10_000))
        step = make_train_step(model, opt, microbatches=microbatches)
        if "pod" in mesh.axis_names:
            pod_grad = master_bytes
        run = lambda: step(state, batch)         # noqa: E731
        tokens = shape.global_batch * shape.seq_len
        flops_mult, alias = 6.0, sbytes
    elif shape.kind == "prefill":
        sbytes = state_bytes(params, logical, mesh, rules)
        extra = {k: v for k, v in batch.items() if k != "tokens"}

        def run():
            with torch.no_grad():
                return model.prefill(batch["tokens"], shape.seq_len,
                                     **extra)
        tokens = shape.global_batch * shape.seq_len
        flops_mult, alias = 2.0, 0
    else:
        caches = model.init_cache(b_local, shape.seq_len)
        full = model.init_cache(shape.global_batch, shape.seq_len) \
            if b_local != shape.global_batch else caches
        cache_bytes = sum(shard_bytes(t, lg, mesh, rules)
                          for t, lg in cache_items(full))
        for t, lg in cache_items(caches):
            spec = spec_lib.partition_spec(lg, tuple(t.shape), mesh, rules)
            hlo_cost.set_shard(t, hlo_cost.state_shard(spec, mesh, False))
        sbytes = state_bytes(params, logical, mesh, rules) + cache_bytes

        def run():
            with torch.no_grad():
                return model.decode_step(caches, batch["tokens"],
                                         shape.seq_len - 1)
        tokens = shape.global_batch
        flops_mult, alias = 2.0, cache_bytes
    n_active = cfg.active_param_count_estimate()
    meta = {
        "arch": arch, "shape": shape.name, "mesh": list(mesh.sizes),
        "n_devices": n_dev, "kind": shape.kind,
        "params_total": cfg.param_count_estimate(),
        "params_active": n_active,
        "tokens_global": tokens,
        "model_flops_per_device": flops_mult * n_active * tokens / n_dev,
        "local_batch": b_local, "microbatches": microbatches,
        "rules": {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in rules.items()},
    }
    return Cell(run, params if train else {}, meta, sbytes, batch_bytes,
                alias, pod_grad)


def count_cell(cell: Cell, mesh, rules) -> tuple:
    """Run ``cell`` once under a cost count: ``(Cost, peak activation
    bytes)``, one device's."""
    with hlo_cost.counting(mesh, rules) as counter:
        hooks = [p.register_post_accumulate_grad_hook(
            counter.grad_accumulated) for p in cell.params.values()]
        try:
            cell.run()
        finally:
            for h in hooks:
                h.remove()
        # the pod axis' all-reduce of the float32 gradient shards, a step
        counter.collective("all-reduce", ("pod",), cell.pod_grad_bytes)
    return counter.cost, counter.peak


def measure(arch: str, shape_name: str, mesh,
            rule_overrides: Optional[Dict[str, Any]] = None,
            microbatches: int = 1, **kw) -> Dict[str, Any]:
    """One cell built and counted: its record's ``memory``,
    ``cost_analysis`` and ``roofline``, with the meta fields."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, mesh, rule_overrides, microbatches,
                      **kw)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    cost, peak = count_cell(cell, mesh, rules_for(arch, rule_overrides))
    t_count = time.perf_counter() - t0
    memory = {
        "argument_bytes": cell.state_bytes + cell.batch_bytes,
        "output_bytes": cell.alias_bytes,
        "temp_bytes": peak,
        "alias_bytes": cell.alias_bytes,
        "peak_est_bytes": cell.state_bytes + cell.batch_bytes + peak,
        "state_bytes": cell.state_bytes,
        "batch_bytes": cell.batch_bytes,
        "activation_peak_est_bytes": peak,
        "peak_is_estimate": True,
    }
    terms = roofline_lib.roofline(
        cost, model_flops_per_device=cell.meta["model_flops_per_device"],
        mesh=mesh, memory_bytes=memory["peak_est_bytes"])
    return {
        **cell.meta,
        "lower_s": round(t_build, 2), "compile_s": round(t_count, 2),
        "memory": memory,
        "cost_analysis": {"flops": cost.flops,
                          "bytes accessed": cost.bytes,
                          "transcendentals": cost.transcendentals,
                          "product_flops": cost.product_flops,
                          "attention_flops": cost.attention_flops,
                          "attention_useful_flops":
                              cost.attention_useful_flops},
        "collectives_by_axis": dict(cost.coll_by_axis),
        "roofline": terms.to_dict(),
    }


def default_microbatches(arch: str, shape_name: str, mesh_kind: str) -> int:
    mb = (ARCH_MICROBATCHES.get(arch, 1)
          if SHAPES[shape_name].kind == "train" else 1)
    # each microbatch must still cover every data-parallel shard
    dp = 32 if mesh_kind == "multi" else 16
    return min(mb, max(SHAPES[shape_name].global_batch // dp, 1))


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             rule_overrides: Optional[Dict[str, Any]] = None,
             out_dir: Path = ARTIFACTS, tag: str = "",
             microbatches: Optional[int] = None,
             verbose: bool = True) -> dict:
    if microbatches is None:
        microbatches = default_microbatches(arch, shape_name, mesh_kind)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{mesh_kind}_{arch}_{shape_name}{('_' + tag) if tag else ''}"
    out_path = out_dir / f"{name}.json"

    ok, why = shape_applicable(get_config(arch), SHAPES[shape_name])
    if not ok:
        rec = {"cell": name, "status": "skipped", "reason": why}
        out_path.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[dryrun] {name}: SKIPPED ({why})")
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        rec = {"cell": name, "status": "ok",
               **measure(arch, shape_name, mesh, rule_overrides,
                         microbatches)}
        if verbose:
            t, m = rec["roofline"], rec["memory"]
            print(f"[dryrun] {name}: flops={t['flops_per_device']:.3e} "
                  f"bytes={t['bytes_per_device']:.3e} "
                  f"T_comp={t['t_compute'] * 1e3:.2f}ms "
                  f"T_mem={t['t_memory'] * 1e3:.2f}ms "
                  f"T_coll={t['t_collective'] * 1e3:.2f}ms -> "
                  f"{t['bottleneck']}-bound (useful-flops ratio "
                  f"{(t['useful_flops_ratio'] or 0):.2f}); state "
                  f"{m['state_bytes'] / 1e9:.3f} GB, activation peak "
                  f"(estimate) {m['temp_bytes'] / 1e9:.3f} GB; "
                  f"{rec['compile_s']:.1f} s", flush=True)
    except Exception as e:  # record failures; they are bugs to fix
        rec = {"cell": name, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[dryrun] {name}: ERROR {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)
    out_path.write_text(json.dumps(rec, indent=2, default=str))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out-dir", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                name = f"{mesh_kind}_{arch}_{shape}" + \
                    (f"_{args.tag}" if args.tag else "")
                path = args.out_dir / f"{name}.json"
                if args.skip_done and path.exists():
                    rec = json.loads(path.read_text())
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] {name}: cached ({rec['status']})")
                        results.append(rec)
                        continue
                results.append(run_cell(arch, shape, mesh_kind,
                                        out_dir=args.out_dir, tag=args.tag,
                                        microbatches=args.microbatches))
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(results)} cells")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
