"""The hill climb: hypothesis -> change -> recount (port of
``repro.launch.hillclimb``).

Three cells, each variant counted on the ``meta`` device on the
single-pod production mesh (16×16), its roofline terms and memory written
to ``artifacts/perf_torch/<cell>_<variant>.json``:

  cell1: internvl2-76b train_4k   (the most collective-bound LM cell)
  cell2: granite-moe train_4k     (the worst useful-FLOPs ratio)
  cell3: the core auction replay  (the paper's workload)

Cells 1 and 2 are dry-run cells (:func:`repro_torch.launch.dryrun.measure`)
under ``repro``'s variants: rule overrides and microbatch counts.

Cell 3 is SORT2AGGREGATE's step 3 at production scale (``repro``'s
``hillclimb.py:57-173``): N = 2^26 events, C = 1,024 campaigns and 64
segments, the events sharded over all 256 positions. Each position's
program is written in torch with the port's ``core.auction.resolve`` and
``spend_sums`` and counted on its local shard (262,144 rows × 1,024
campaigns); its ``psum``, ``all_gather`` and ``pmin`` are logical
collectives over the 256 ranks. The cell's rule has unit multipliers and
no reserve, so bfloat16 values resolve to the winners and prices of their
float32 upcast (a bfloat16 value times 1 is itself): the port resolves
the values in the dtype they are stored in, where XLA fuses the
reference's upcast into the resolve. Spends stay float32.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell cell3
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.launch import dryrun
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import spec as spec_lib

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "perf_torch"


def _record(cell: str, variant: str, terms: rl.RooflineTerms, meta: dict,
            peak_bytes: float, out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    rec = {"cell": cell, "variant": variant, **meta,
           "roofline": terms.to_dict(), "peak_gb": peak_bytes / 1e9}
    (out_dir / f"{cell}_{variant}.json").write_text(
        json.dumps(rec, indent=2, default=str))
    t = terms
    print(f"[{cell}/{variant}] T_comp={t.t_compute * 1e3:.1f}ms "
          f"T_mem={t.t_memory * 1e3:.1f}ms "
          f"T_coll={t.t_collective * 1e3:.1f}ms -> {t.bottleneck}  "
          f"peak={rec['peak_gb']:.1f}GB (estimate)", flush=True)
    return rec


# ---------------------------------------------------------------------------
# Cell 3: the core auction replay (SORT2AGGREGATE step 3 at production scale)

N_EVENTS, N_CAMPAIGNS, N_SEGS = 1 << 26, 1024, 64
EVENT_AXES = ("data", "model")

CELL3_VARIANTS = {
    # paper-faithful baseline
    "baseline_fp32": dict(),
    # H1: bf16 valuations (the values' bytes halve; spends stay fp32)
    "bf16_values": dict(values_dtype=torch.bfloat16),
    # H2: blocked crossing scan (bound the (N_local, C) one-hot)
    "blocked_crossing": dict(values_dtype=torch.bfloat16,
                             crossing_block=4096),
    # H3: bf16 one-hot accumulate in the crossing
    "bf16_onehot": dict(values_dtype=torch.bfloat16, crossing_block=4096,
                        use_bf16_onehot=True),
}


def cell3_shard(values_local: torch.Tensor, bnds: torch.Tensor,
                msks: torch.Tensor, budgets: torch.Tensor, *, rank: int,
                n_ranks: int, crossing_block: int = 0,
                use_bf16_onehot: bool = False, counter=None):
    """One rank's aggregate step: its events' segment masks, the resolve,
    its spend sums, their ``psum``; the exclusive prefix of the other
    ranks' sums (``all_gather``); the first crossing of each budget in its
    rows (blocked by ``crossing_block``); the ``pmin`` of the crossings.
    ``counter`` records the collectives. Returns ``(total, cap)``."""
    from repro_torch.core import auction
    from repro_torch.core.types import AuctionRule
    dev = values_local.device
    local_n, c = values_local.shape
    offset = rank * local_n
    rule = AuctionRule.first_price(c, device=dev)
    gidx = offset + torch.arange(local_n, dtype=torch.int32, device=dev)
    seg_ids = torch.searchsorted(bnds[1:-1], gidx, right=True)
    act = msks[seg_ids]
    winners, prices = auction.resolve(values_local, act, rule)
    local_sum = auction.spend_sums(winners, prices, c)
    sum_bytes = local_sum.numel() * 4
    if counter is not None:
        counter.collective("all-reduce", EVENT_AXES, sum_bytes)
        counter.collective("all-gather", EVENT_AXES, sum_bytes * n_ranks)
    total = local_sum               # its psum: the same shape and bytes
    all_sums = local_sum[None].expand(n_ranks, c).contiguous()
    before = (torch.arange(n_ranks, device=dev) < rank).to(torch.float32)
    s0 = (all_sums * before[:, None]).sum(dim=0)
    oh_dtype = torch.bfloat16 if use_bf16_onehot else torch.float32
    sentinel = N_EVENTS + 1
    cols = torch.arange(c, device=dev)

    def crossings(w, p, s_run, row0):
        onehot = (cols[None, :] == w[:, None]).to(oh_dtype)
        cum = s_run[None, :] + torch.cumsum(
            onehot * p[:, None].to(oh_dtype), dim=0).to(torch.float32)
        crossed = cum >= budgets[None, :]
        t_first = torch.argmax(crossed.to(torch.uint8), dim=0)
        return cum[-1], crossed.any(dim=0), offset + row0 + t_first + 1

    if crossing_block:
        cap = torch.full((c,), sentinel, dtype=torch.int32, device=dev)
        s_run = s0
        for row0 in range(0, local_n, crossing_block):
            rows = slice(row0, row0 + crossing_block)
            s_run, hit, t = crossings(winners[rows], prices[rows], s_run,
                                      row0)
            cap = torch.where((cap == sentinel) & hit, t.to(torch.int32),
                              cap)
    else:
        _, hit, t = crossings(winners, prices, s0, 0)
        cap = torch.where(hit, t.to(torch.int32), sentinel)
    if counter is not None:
        counter.collective("all-reduce", EVENT_AXES, cap.numel() * 4)
    return total, cap


def cell3(variants=None, out_dir: Path = ARTIFACTS) -> dict:
    """Count each variant of cell 3 on one rank's shard; returns the
    records by variant."""
    mesh = make_production_mesh(multi_pod=False)
    n_dev = mesh.size
    local_n = N_EVENTS // n_dev
    meta_dev = torch.device("meta")
    model_flops = 3.0 * N_EVENTS * N_CAMPAIGNS / n_dev
    out = {}
    for name, kw in CELL3_VARIANTS.items():
        if variants and name not in variants:
            continue
        t0 = time.perf_counter()
        dtype = kw.get("values_dtype", torch.float32)
        values = torch.empty((local_n, N_CAMPAIGNS), dtype=dtype,
                             device=meta_dev)
        bnds = torch.empty((N_SEGS + 2,), dtype=torch.int32, device=meta_dev)
        msks = torch.empty((N_SEGS + 1, N_CAMPAIGNS), dtype=torch.bool,
                           device=meta_dev)
        budgets = torch.empty((N_CAMPAIGNS,), dtype=torch.float32,
                              device=meta_dev)
        with hlo_cost.counting(mesh, spec_lib.resolve_rules()) as counter:
            cell3_shard(values, bnds, msks, budgets, rank=1, n_ranks=n_dev,
                        crossing_block=kw.get("crossing_block", 0),
                        use_bf16_onehot=kw.get("use_bf16_onehot", False),
                        counter=counter)
        inputs = sum(t.numel() * t.element_size()
                     for t in (values, bnds, msks, budgets))
        terms = rl.roofline(counter.cost, model_flops_per_device=model_flops,
                            mesh=mesh, memory_bytes=inputs + counter.peak)
        out[name] = _record(
            "cell3", name, terms,
            {"n_events": N_EVENTS, "n_campaigns": N_CAMPAIGNS,
             "local_rows": local_n, "values_bytes": values.numel()
             * values.element_size(), "input_bytes": inputs,
             "activation_peak_est_bytes": counter.peak,
             "compile_s": round(time.perf_counter() - t0, 1)},
            inputs + counter.peak, out_dir)
    return out


# ---------------------------------------------------------------------------
# Cells 1 & 2: LM train cells through the dry run's measure, lever overrides

def _lm_cell(cell: str, arch: str, variants, out_dir: Path) -> dict:
    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for name, (rules, mb) in variants.items():
        t0 = time.perf_counter()
        try:
            rec = dryrun.measure(arch, "train_4k", mesh,
                                 rule_overrides=rules, microbatches=mb)
            terms = rl.RooflineTerms(**rec["roofline"])
            out[name] = _record(
                cell, name, terms,
                {"arch": arch, "rules": {k: str(v) for k, v in
                                         (rules or {}).items()},
                 "microbatches": mb, "memory": rec["memory"],
                 "cost_analysis": rec["cost_analysis"],
                 "collectives_by_axis": rec["collectives_by_axis"],
                 "compile_s": round(time.perf_counter() - t0, 1)},
                rec["memory"]["peak_est_bytes"], out_dir)
        except Exception as e:  # record the failure; the other variants run
            print(f"[{cell}/{name}] ERROR {type(e).__name__}: {str(e)[:200]}"
                  f"\n{traceback.format_exc()[-2000:]}", flush=True)
    return out


CELL1_VARIANTS = {
    # paper-faithful baseline: FSDP+TP+SP, mb=8
    "baseline_sp": ({"act_seq": "model"}, 8),
    # H1: explicit ZeRO-3 weight gathering (bf16 gather over data)
    "gather_weights": ({"act_seq": "model", "_gather_weights": True}, 8),
    # H2: no SP; act_seq must be nulled explicitly, as ARCH_RULES pins it
    # for this arch
    "no_sp_gather": ({"act_seq": None, "_gather_weights": True}, 8),
    # H3: fewer microbatches (fewer weight regathers, more activations)
    "gather_mb4": ({"act_seq": "model", "_gather_weights": True}, 4),
    # H4: no SP with mb=16 (a smaller unsharded residual stack)
    "no_sp_gather_mb16": ({"act_seq": None, "_gather_weights": True}, 16),
}

_GRANITE = {"expert": "model", "ff": None}
CELL2_VARIANTS = {
    "baseline_ep": (dict(_GRANITE), 4),
    # H1: TP over ff instead of EP
    "tp_ff": ({"expert": None, "ff": "model"}, 4),
    # H2: EP + gather_weights
    "ep_gather": ({**_GRANITE, "_gather_weights": True}, 4),
    # H3: more microbatches (smaller dispatch tensors per step)
    "ep_mb8": (dict(_GRANITE), 8),
}


def cell1(variants=None, out_dir: Path = ARTIFACTS) -> dict:
    """internvl2-76b train_4k: attack the collective term."""
    return _lm_cell("cell1", "internvl2-76b",
                    {k: v for k, v in CELL1_VARIANTS.items()
                     if not variants or k in variants}, out_dir)


def cell2(variants=None, out_dir: Path = ARTIFACTS) -> dict:
    """granite-moe train_4k: attack the useful-FLOPs ratio / memory."""
    return _lm_cell("cell2", "granite-moe-3b-a800m",
                    {k: v for k, v in CELL2_VARIANTS.items()
                     if not variants or k in variants}, out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True,
                    choices=["cell1", "cell2", "cell3"])
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--out-dir", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)
    {"cell1": cell1, "cell2": cell2, "cell3": cell3}[args.cell](
        args.variants, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
