#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, one
   process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card, at the
   paper's §7.1 width (N=1,000,000 events, C=100 campaigns, S=32 designs),
   from a fresh and from a mid-day state, under both pricing rules:
   ``round_fused`` and ``sweep_partials`` (partials at rtol 1e-5),
   ``sweep_resolve`` (winners and prices bitwise, sums at rtol 1e-5, atol
   1e-6·max; its (S, N, C)-mask form at N=65,536, C=64, S=8),
   ``segment_partials`` (bitwise the plain version on the CPU),
   ``auction_resolve`` on the day's own embeddings (EmbTile) and on its
   valuation matrix (MatrixTile), each with a (C,) and an (N, C) mask and
   a reserve (winners and prices bitwise; sums at rtol 1e-5, and
   MatrixTile's bitwise the plain version on the CPU), ``first_crossing``
   of the 32 resolved lanes (cap times bitwise the plain version on the
   card and, for one lane, on the CPU; spends bitwise the CPU) and
   ``capped_scan`` at N=65,536, C=64, S=8 with a reserve, a zero budget and
   a zero multiplier (bitwise the plain version on the card);
3. hold the fused-round sweep on the card against the plain torch sweep on
   the CPU at a reduced size (N=65,536, C=64, S=8): every integer output
   equal, spends at rtol 1e-6;
4. run the main path, ``CounterfactualEngine.sweep(grid,
   method="parallel")`` with ``resolve="auto"``, at full width for both
   pricing rules; the launch counters show it went through the fused
   kernels, a second run must give the same bits, the torch path on the
   card (its partials through ``segment_partials``) must give the same six
   outputs bit for bit, and one lane per rule must be bitwise the torch path
   on the CPU;
5. run the exact replay, ``engine.sweep(grid, method="sequential")``, at
   full width for both rules: one ``capped_scan`` launch each, a second
   launch gives the same bits, and the first 131,072 events of lane 0
   (first price) and lane 31 (second price) are bitwise the plain version
   on the CPU;
6. three back-ends, one answer: ``sweep_state_machine`` with ``resolve`` in
   ``"torch"``, ``"sweep_resolve"`` and ``"fused"`` gives identical six
   outputs at full width for both rules; the counters show
   ``"sweep_resolve"`` launched ``sweep_resolve`` once a round and
   ``segment_partials`` twice; ``engine.simulate(method="parallel")`` of
   lane 0's design equals lane 0 for each back-end;
7. the paper's comparison: Algorithm 2 against the exact replay, per lane,
   in mean relative spend error (each < 0.08), capped campaigns and cap-time
   shift, and both sweeps' wall times;
8. SORT2AGGREGATE at full width for both rules: ``engine.simulate()``
   (default method and settings: Algorithm 4, the refinement, the
   aggregate pass) and ``engine.sweep(grid, method="sort2aggregate")`` with
   the base design's warm start; the counters show both went through
   ``auction_resolve`` and ``first_crossing`` and nothing else, no
   ``index_add_`` ran, a second run gives the same bits, and at N=65,536,
   C=64, S=8 every output is bitwise the port on the CPU; then its
   accuracy against phase 5's exact replay, per lane, with every lane
   whose consistency gap is 0 (a self-consistent segment history) within
   a spend-weighted error of 0.02 (``tests/test_core_s2a.py``'s bound);
9. print the numbers: the card's name and power limit, each kernel's time
   beside its plain version's, its library yardstick's and its bound,
   per-round and sweep times, the SORT2AGGREGATE wall times and Algorithm
   4's share of them, peak memory, and one JSON line describing each
   kernel. The plain capped scan is one chain of small launches per
   event, so it is timed over the first 16,384 events of the full day
   (``plain_events`` in the JSON line); every other time is at the full
   shapes.

Every check raises on failure and nothing is caught, so any failure exits
non-zero. The last line is the JSON result. Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, it exits 2
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM fp32, non-tensor (data sheet)
GRID_AXES = dict(bid_scales=(1.0, 0.9, 1.1, 1.3), reserves=(0.0, 0.05),
                 budget_scales=(1.0, 0.8, 1.25, 1.5))
SMALL_AXES = dict(bid_scales=(1.0, 1.2), reserves=(0.0, 0.05),
                  budget_scales=(1.0, 0.5))
KINDS = ("first_price", "second_price")
RESOLVES = ("torch", "sweep_resolve", "fused")
OUTPUTS = ("final_spend", "cap_times", "retired", "boundaries", "num_rounds",
           "n_hat")
PREFIX = 131_072                # events of the exact replay checked on the CPU
PLAIN_EVENTS = 16_384           # events of the plain capped scan timed on card
CPU_LANE = {"first_price": 0, "second_price": 31}
ORACLE_TOL = 0.08               # tests/test_core_parallel.py's bound
S2A_TOL = 0.02                  # tests/test_core_s2a.py's bound
KERNELS = (   # name, CUDA source, the TPU kernel (or XLA op) it replaces
    ("round_fused", "src/repro_torch/csrc/round_fused.cu",
     "src/repro/kernels/auction_resolve/round_fused.py:197"),
    ("sweep_partials", "src/repro_torch/csrc/round_fused.cu",
     "src/repro/kernels/auction_resolve/round_fused.py:301"),
    ("sweep_resolve", "src/repro_torch/csrc/sweep_resolve.cu",
     "src/repro/kernels/auction_resolve/sweep_resolve.py:81"),
    ("capped_scan", "src/repro_torch/csrc/capped_scan.cu",
     "src/repro/kernels/capped_scan/capped_scan.py:75"),
    ("segment_partials", "src/repro_torch/csrc/segment_partials.cu",
     "src/repro/core/segments.py:130"),
    ("auction_resolve", "src/repro_torch/csrc/auction_resolve.cu",
     "src/repro/kernels/auction_resolve/auction_resolve.py:80"),
    ("first_crossing", "src/repro_torch/csrc/first_crossing.cu",
     "src/repro/core/segments.py:68"),
)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and fp32 operations over the fp32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def resolve_cost(n, c, s, rows, second_price, outputs):
    """Bytes and operations of resolving ``rows`` (lane, event) pairs of an
    (N, C) matrix for S lanes: the valuation rows read once, the (S, C)
    lane inputs, the outputs written once; a multiply and a compare per
    (lane, row, campaign) (a second compare for second price)."""
    n_bytes = n * c * 4 + s * (c * 5 + 16) + outputs
    n_ops = rows * c * (3 if second_price else 2)
    return n_bytes, n_ops


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import prng
    from repro_torch.configs.paper_auction import (PAPER_SYNTHETIC_CPU,
                                                   PAPER_SYNTHETIC_FULL)
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, scenario_rule,
                                  spend_weighted_relative_error,
                                  sweep_sequential, sweep_state_machine)
    from repro_torch.core import auction, executor
    from repro_torch.core import segments as seg_lib
    from repro_torch.core import vi as vi_lib
    from repro_torch.core.segments import REDUCE_BLOCKS
    from repro_torch.data import make_synthetic_env
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import ops, ref
    from repro_torch.kernels.auction_resolve import auction_resolve as ar_mod
    from repro_torch.kernels.auction_resolve import first_crossing as fc_mod
    from repro_torch.kernels.auction_resolve import round_fused as rf_mod
    from repro_torch.kernels.auction_resolve import segment_partials as sp_mod
    from repro_torch.kernels.auction_resolve import sweep_resolve as sr_mod
    from repro_torch.kernels.capped_scan import capped_scan as cs_mod
    from repro_torch.kernels.capped_scan import ops as scan_ops
    from repro_torch.kernels.capped_scan.ref import capped_scan_ref

    counters = (rf_mod, sr_mod, sp_mod, cs_mod, ar_mod, fc_mod)

    def reset_counts():
        for mod in counters:
            mod.reset_launches()

    def read_counts() -> dict:
        return {k: v for mod in counters for k, v in mod.LAUNCHES.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(f"card: {card} | max SM clock {smi('clocks.max.sm')} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all(["round_fused", "sweep_resolve",
                             "segment_partials", "capped_scan",
                             "auction_resolve", "first_crossing"])
    print(f"[1] built {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, (lib_path, log, seconds) in built.items():
        print(f"    {lib_path.name}: nvcc {seconds:.2f} s")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"      ptxas: {line.strip()}")

    # ---- phase 2: kernels vs plain versions ------------------------------
    full = PAPER_SYNTHETIC_FULL
    t0 = time.perf_counter()
    env = make_synthetic_env(args.seed, full.n_events, full.n_campaigns,
                             full.emb_dim, b_base=full.b_base, device=dev)
    small_cfg = PAPER_SYNTHETIC_CPU
    small = make_synthetic_env(args.seed, small_cfg.n_events,
                               small_cfg.n_campaigns, small_cfg.emb_dim,
                               b_base=small_cfg.b_base, device=dev)
    torch.cuda.synchronize()
    n, c = env.values.shape
    block = -(-n // REDUCE_BLOCKS)
    print(f"[2] env N={n} C={c}: values {env.values.numel() * 4 / 1e6:.0f} "
          f"MB on the card, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    gen = torch.Generator().manual_seed(args.seed + 1)
    card_gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    errs = {name: 0.0 for name, _, _ in KERNELS}

    def close(name, got, want, mask=None):
        if mask is not None:
            got, want = got[mask], want[mask]
        tol = 1e-6 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        errs[name] = max(errs[name], float((got - want).abs().max()))

    def equal(name, got, want, what):
        require(got.dtype == want.dtype and torch.equal(got, want),
                f"{what}: {name} differs from its plain version")

    def base_grid(kind, budgets, axes):
        base = AuctionRule(multipliers=torch.ones(budgets.shape[0],
                                                  device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        return ScenarioGrid.product(base, budgets, **axes)

    def check_round(label, grid, active, s_hat, n_hat, alive, second):
        out = ops.round_fused(env.values, grid.rules.multipliers, active,
                              grid.rules.reserve, grid.budgets, s_hat, n_hat,
                              alive, reduce_blocks=REDUCE_BLOCKS,
                              second_price=second)
        want = ref.round_fused_ref(
            env.values, grid.rules.multipliers, active, grid.rules.reserve,
            grid.budgets, s_hat, n_hat, block_size=block,
            second_price=second)
        torch.cuda.synchronize()
        close("round_fused", out[0], want[0], alive)
        require(torch.equal(out[2][alive], want[2][alive]),
                f"{label}: c_next differs")
        require(torch.equal(out[3][alive], want[3][alive]),
                f"{label}: no_cap differs")
        off = (out[4] - want[4])[alive].abs()
        if int(off.max()) > 0:
            print(f"    {label}: n_next off by {off.tolist()}")
        require(int(off.max()) <= 1, f"{label}: n_next off by more than 1")
        # the block window is the kernel's own n_next; compare where both
        # predicted the same block
        same = alive & (out[4] == want[4])
        close("round_fused", out[1], want[1], same)
        require(not out[0][~alive].any() and not out[1][~alive].any(),
                f"{label}: skipped lanes wrote non-zero partials")
        return out

    def check_sweep_resolve(label, values, mult, active, reserves, second):
        got = ops.sweep_resolve(values, mult, active, reserves,
                                second_price=second)
        want = ref.sweep_resolve_ref(values, mult, active, reserves,
                                     second_price=second)
        torch.cuda.synchronize()
        equal("winners", got[0], want[0], f"sweep_resolve {label}")
        equal("prices", got[1], want[1], f"sweep_resolve {label}")
        close("sweep_resolve", got[2], want[2])
        return got

    timing = {}
    for kind in KINDS:
        second = kind == "second_price"
        grid = base_grid(kind, env.budgets, GRID_AXES)
        s = grid.num_scenarios
        mult, res = grid.rules.multipliers, grid.rules.reserve
        ones = torch.ones((s, c), dtype=torch.bool, device=dev)
        zeros = torch.zeros((s, c), device=dev)
        n0 = torch.zeros(s, dtype=torch.int32, device=dev)
        full_hi = torch.full_like(n0, n)
        all_alive = torch.ones(s, dtype=torch.bool, device=dev)
        fresh = check_round(f"{kind} fresh", grid, ones, zeros, n0,
                            all_alive, second)
        # mid-day: n_hat ~ N/3, a quarter of the campaigns retired with
        # part of their budgets spent, every fourth lane dead
        active = (torch.rand((s, c), generator=gen) < 0.75).to(dev)
        s_hat = grid.budgets * 0.3 * torch.rand((s, c), generator=gen).to(dev)
        n_mid = (n // 3 + (n // 256) * torch.arange(s)).to(torch.int32)
        n_mid = n_mid.to(dev)
        alive = (torch.arange(s) % 4 != 3).to(dev)
        check_round(f"{kind} mid-day", grid, active, s_hat, n_mid, alive,
                    second)
        # one partials pass over a slice of the log at a non-zero offset,
        # with a window per lane
        offset, n_local = n // 4, n // 2
        lo = (offset - n // 200 + (n // 80) * torch.arange(s))
        lo, hi = lo.to(torch.int32), (lo + 2 * n // 5).to(torch.int32)
        lo, hi = lo.to(dev), hi.to(dev)
        v_slice = env.values[offset:offset + n_local]
        got = ops.sweep_partials(v_slice, mult, active, res, lo, hi,
                                 all_alive, offset, n_events_global=n,
                                 reduce_blocks=REDUCE_BLOCKS,
                                 second_price=second)
        want = ref.fused_partials_ref(v_slice, mult, active, res, lo, hi,
                                      block_size=block, second_price=second,
                                      index_offset=offset)
        close("sweep_partials", got, want)
        # the scenario-batched resolve, fresh and mid-day masks
        resolved = check_sweep_resolve(f"{kind} fresh", env.values, mult,
                                       ones, res, second)
        mid = check_sweep_resolve(f"{kind} mid-day", env.values, mult, active,
                                  res, second)
        # event-ordered partials of the mid-day resolve, a window per lane:
        # bitwise the plain version (index_add_) on the CPU
        win_hi = torch.clamp(n_mid + (n // 7) * (1 + torch.arange(
            s, device=dev) % 5), max=n).to(torch.int32)
        got = seg_lib.window_partials(mid[0], mid[1], c, n_mid, win_hi,
                                      block_size=block)
        want = seg_lib.window_partials_ref(mid[0].cpu(), mid[1].cpu(), c,
                                           n_mid.cpu(), win_hi.cpu(),
                                           block_size=block)
        equal("partials", got.cpu(), want, f"segment_partials {kind}")
        print(f"[2] {kind}: round (fresh, mid-day), offset partials, "
              f"sweep_resolve (fresh, mid-day) and segment_partials agree "
              f"with the plain versions", flush=True)
        if kind == "first_price":
            # time the fresh-state round, one full-window pass, the fresh
            # resolve and its full-window partials
            args_rf = (env.values, mult, ones, res, grid.budgets, zeros, n0,
                       all_alive)
            timing["round_fused"] = (
                cuda_ms(lambda: ops.round_fused(
                    *args_rf, reduce_blocks=REDUCE_BLOCKS), 10),
                cuda_ms(lambda: ref.round_fused_ref(
                    *args_rf[:7], block_size=block), 3), None)
            timing["sweep_partials"] = (
                cuda_ms(lambda: ops.sweep_partials(
                    env.values, mult, ones, res, n0, full_hi, all_alive,
                    n_events_global=n, reduce_blocks=REDUCE_BLOCKS), 10),
                cuda_ms(lambda: ref.fused_partials_ref(
                    env.values, mult, ones, res, n0, full_hi,
                    block_size=block), 3), None)
            timing["sweep_resolve"] = (
                cuda_ms(lambda: ops.sweep_resolve(env.values, mult, ones,
                                                  res), 10),
                cuda_ms(lambda: ref.sweep_resolve_ref(env.values, mult, ones,
                                                      res), 3), None)
            w, p = resolved[0], resolved[1]
            # the library yardstick: one index_add_ over every lane's rows
            flat_ids = ((torch.arange(s, device=dev)[:, None] * REDUCE_BLOCKS
                         + torch.arange(n, device=dev) // block)
                        * (c + 1) + torch.where(w < 0, c, w)).reshape(-1)
            flat_p = p.reshape(-1)
            timing["segment_partials"] = (
                cuda_ms(lambda: seg_lib.window_partials(
                    w, p, c, n0, full_hi, block_size=block), 10),
                cuda_ms(lambda: seg_lib.window_partials_ref(
                    w, p, c, n0, full_hi, block_size=block), 3),
                cuda_ms(lambda: torch.zeros(
                    s * REDUCE_BLOCKS * (c + 1), device=dev).index_add_(
                        0, flat_ids, flat_p), 10))
            del flat_ids, flat_p, w, p
            out_bytes = s * REDUCE_BLOCKS * c * 4
            rows_block = int(fresh[4].sum())
            timing["round_fused_bound"] = bound_ms(*resolve_cost(
                n, c, s, s * n + rows_block, False, 2 * out_bytes + 9 * s))
            timing["sweep_partials_bound"] = bound_ms(*resolve_cost(
                n, c, s, s * n, False, out_bytes))
            timing["sweep_resolve_bound"] = bound_ms(*resolve_cost(
                n, c, s, s * n, False, s * n * 8 + s * c * 4))
            timing["segment_partials_bound"] = bound_ms(
                s * n * 8 + s * 8 + out_bytes, s * n)
            round_bodies = {}
            for resolve in RESOLVES:
                round_bodies[resolve] = executor._make_round_body(
                    executor.SweepPlan(resolve=resolve), resolve,
                    values=env.values, rules=grid.rules,
                    budgets_f32=grid.budgets, n_events=n, n_campaigns=c)
            core0 = (zeros, ones, torch.full((s, c), n + 1, dtype=torch.int32,
                                             device=dev),
                     n0, n0, torch.full((s, c + 1), -1, dtype=torch.int32,
                                        device=dev),
                     torch.zeros((s, c + 2), dtype=torch.int32, device=dev))
            timing["round_ms"] = {
                resolve: cuda_ms(lambda: body(core0, all_alive), reps)
                for (resolve, body), reps in zip(round_bodies.items(),
                                                 (3, 10, 10))}
        # the single-design resolve: EmbTile on the day's own embeddings,
        # MatrixTile on its valuation matrix; a (C,) and an (N, C) mask, a
        # reserve, the bids of lane 5
        mult1 = mult[5].contiguous()
        res1 = torch.tensor(0.05, device=dev)
        cmask = torch.rand(c, generator=card_gen, device=dev) < 0.8
        nmask = torch.rand((n, c), generator=card_gen, device=dev) < 0.8
        for mname, mask in (("(C,) mask", cmask), ("(N, C) mask", nmask)):
            what = f"auction_resolve {kind} {mname}"
            got = ops.auction_resolve(env.event_emb, env.campaign_emb, mult1,
                                      mask, res1, second_price=second)
            want = ref.auction_resolve_ref(env.event_emb, env.campaign_emb,
                                           mult1, mask, res1,
                                           second_price=second)
            torch.cuda.synchronize()
            equal("winners", got[0], want[0], f"{what} EmbTile")
            equal("prices", got[1], want[1], f"{what} EmbTile")
            close("auction_resolve", got[2], want[2])
            got = ops.resolve_masked(env.values, mult1, mask, res1,
                                     second_price=second)
            want = ref.resolve_masked_ref(env.values, mult1, mask, res1,
                                          second_price=second)
            on_cpu = ref.resolve_masked_ref(env.values.cpu(), mult1.cpu(),
                                            mask.cpu(), res1.cpu(),
                                            second_price=second)
            equal("winners", got[0], want[0], f"{what} MatrixTile")
            equal("prices", got[1], want[1], f"{what} MatrixTile")
            close("auction_resolve", got[2], want[2])
            equal("sums", got[2].cpu(), on_cpu[2], f"{what} MatrixTile on "
                  f"the CPU")
        # the first crossings and spends of the 32 resolved lanes: cap times
        # bitwise the plain version on the card and (one lane) on the CPU,
        # spends bitwise the CPU's event-ordered sums
        w, p = resolved[0], resolved[1]
        fc_spend, fc_cap = seg_lib.crossing_and_spend(w, p, grid.budgets, c)
        plain_cap = seg_lib.first_crossing_ref(w, p, grid.budgets, c)
        torch.cuda.synchronize()
        equal("cap times", fc_cap, plain_cap, f"first_crossing {kind}")
        equal("spend", fc_spend.cpu(), auction.spend_sums(w.cpu(), p.cpu(), c),
              f"first_crossing {kind} on the CPU")
        lane = CPU_LANE[kind]
        equal("cap times", fc_cap[lane].cpu(), seg_lib.first_crossing_ref(
            w[lane].cpu(), p[lane].cpu(), grid.budgets[lane].cpu(), c),
            f"first_crossing {kind} lane {lane} on the CPU")
        require(bool((fc_cap <= n).any()) and bool((fc_cap > n).any()),
                f"first_crossing {kind}: the lanes should cap some campaigns "
                f"and not others")
        print(f"[2] {kind}: auction_resolve (EmbTile and MatrixTile, both "
              f"masks) and first_crossing ({int((fc_cap <= n).sum())} "
              f"crossings in {s} lanes) agree with the plain versions",
              flush=True)
        if kind == "first_price":
            # auction_resolve at the shape of an aggregate pass (MatrixTile,
            # an (N, C) mask, no sums) and at the embeddings' (EmbTile, a
            # (C,) mask, sums); first_crossing of 32 lanes
            timing["auction_resolve"] = (
                cuda_ms(lambda: ops.resolve_masked(
                    env.values, mult1, nmask, res1, sums=False), 10),
                cuda_ms(lambda: ref.resolve_masked_ref(
                    env.values, mult1, nmask, res1), 3), None)
            timing["auction_resolve_emb"] = (
                cuda_ms(lambda: ops.auction_resolve(
                    env.event_emb, env.campaign_emb, mult1, cmask, res1), 10),
                cuda_ms(lambda: ref.auction_resolve_ref(
                    env.event_emb, env.campaign_emb, mult1, cmask, res1), 3))
            timing["first_crossing"] = (
                cuda_ms(lambda: seg_lib.crossing_and_spend(
                    w, p, grid.budgets, c), 3),
                cuda_ms(lambda: seg_lib.first_crossing_ref(
                    w, p, grid.budgets, c), 1), None)
            d = env.event_emb.shape[1]
            timing["auction_resolve_bound"] = bound_ms(
                n * c * 4 + n * c + c * 4 + 4 + n * 8, n * c * 2)
            timing["auction_resolve_emb_bound"] = bound_ms(
                (n + c) * d * 4 + c * 5 + 4 + n * 8 + c * 4,
                n * c * (2 * d + 6))
            timing["first_crossing_bound"] = bound_ms(
                s * n * 8 + s * c * 12, s * n * c * 3)
        del resolved, mid, w, p, nmask

    # the per-event (S, N, C) mask and the exact replay at the reduced size
    for kind in KINDS:
        second = kind == "second_price"
        grid = base_grid(kind, small.budgets, SMALL_AXES)
        s, (n_s, c_s) = grid.num_scenarios, small.values.shape
        per_event = (torch.rand((s, n_s, c_s), generator=gen) < 0.75).to(dev)
        check_sweep_resolve(f"{kind} per-event mask", small.values,
                            grid.rules.multipliers, per_event,
                            grid.rules.reserve, second)
        del per_event
        budgets = grid.budgets.clone()
        budgets[:, 2] = 0.0                     # caps at event 1, unsold
        mult = grid.rules.multipliers.clone()
        mult[:, 3] = 0.0                        # never bids above a reserve
        got = scan_ops.capped_scan(small.values, budgets, mult,
                                   grid.rules.reserve, second_price=second)
        t0 = time.perf_counter()
        want = capped_scan_ref(small.values, budgets, mult,
                               grid.rules.reserve, second_price=second)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        for name, a, b in zip(("winners", "prices", "final_spend",
                               "cap_times"), got, want):
            equal(name, a, b, f"capped_scan {kind}")
        require(bool((got[3][:, 2] == 1).all()),
                f"capped_scan {kind}: a zero budget did not cap at event 1")
        print(f"[2] {kind}: sweep_resolve with an (S, N, C) mask and "
              f"capped_scan (reserve, zero budget, zero multiplier) agree "
              f"with the plain versions at N={n_s} C={c_s} S={s}; the plain "
              f"capped scan took {plain_s:.2f} s on the card "
              f"({plain_s / n_s * 1e6:.2f} us per event)", flush=True)

    # ---- phase 3: exactness at a reduced size ----------------------------
    for kind in KINDS:
        grid = base_grid(kind, small.budgets, SMALL_AXES)
        t0 = time.perf_counter()
        on_card = sweep_state_machine(small.values, grid.budgets, grid.rules,
                                      resolve="fused")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rules_cpu = AuctionRule(multipliers=grid.rules.multipliers.cpu(),
                                reserve=grid.rules.reserve.cpu(), kind=kind)
        on_cpu = sweep_state_machine(small.values.cpu(), grid.budgets.cpu(),
                                     rules_cpu, resolve="torch")
        t2 = time.perf_counter()
        for name, a, b in zip(OUTPUTS[1:], on_card[1:], on_cpu[1:]):
            require(torch.equal(a.cpu(), b), f"phase 3 {kind}: {name} differs")
        torch.testing.assert_close(on_card[0].cpu(), on_cpu[0], rtol=1e-6,
                                   atol=0.0)
        bitwise = all(torch.equal(a.cpu(), b) for a, b in zip(on_card,
                                                               on_cpu))
        print(f"[3] {kind}: N={small.n_events} C={small.n_campaigns} S=8 "
              f"fused on the card == torch on the CPU (bitwise: {bitwise}); "
              f"rounds {on_card[4].tolist()}; {t1 - t0:.2f} s on the card, "
              f"{t2 - t1:.2f} s on the CPU", flush=True)

    # ---- phase 4: the main path at full width ----------------------------
    results = {}
    counted = {name: 0 for name, _, _ in KERNELS}
    peak = {"fused": 0, "torch": 0}
    engines = {}
    for kind in KINDS:
        base = AuctionRule(multipliers=torch.ones(c, device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        engine = CounterfactualEngine(env.values, env.budgets, base_rule=base)
        grid = engine.grid(**GRID_AXES)
        engines[kind] = (engine, grid)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sweep = engine.sweep(grid, method="parallel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak["fused"] = max(peak["fused"], torch.cuda.max_memory_allocated())
        for name in ("round_fused", "sweep_partials"):
            counted[name] += launches[name]
        spend, caps = sweep.results.final_spend, sweep.results.cap_times
        require(bool(torch.isfinite(spend).all())
                and tuple(spend.shape) == (grid.num_scenarios, c)
                and bool((spend >= 0).all()),
                f"{kind}: spends not finite, negative or of the wrong shape")
        # the same sweep again: the kernels are deterministic
        fused = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                    resolve="fused")
        rounds = int(fused[4].max())
        require(launches["round_fused"] == rounds,
                f"{kind}: {launches['round_fused']} round_fused launches for "
                f"{rounds} rounds")
        require(launches["sweep_partials"] == 2 * rounds,
                f"{kind}: {launches['sweep_partials']} partials launches for "
                f"{rounds} rounds")
        require(torch.equal(spend, fused[0]) and torch.equal(caps, fused[1]),
                f"{kind}: a second fused sweep gave other bits")
        # the plain torch path on the card, one lane at a time: its
        # partials go through the event-ordered segment_partials kernel, so
        # it must give the fused path's bits
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                    resolve="torch")
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        torch_counts = read_counts()
        peak["torch"] = max(peak["torch"], torch.cuda.max_memory_allocated())
        plain_rounds = int(plain[4].max())
        require(torch_counts["segment_partials"] == 2 * plain_rounds,
                f"{kind}: torch path made {torch_counts['segment_partials']} "
                f"segment_partials launches for {plain_rounds} rounds")
        for name, a, b in zip(OUTPUTS, fused, plain):
            require(torch.equal(a, b),
                    f"{kind}: the torch path's {name} differs from the fused "
                    f"path's")
        # one lane at full width against the torch path on the CPU, where
        # index_add_ sums in event order as the kernels do: the same bits
        lane = CPU_LANE[kind]
        rule_cpu = AuctionRule(
            multipliers=grid.rules.multipliers[lane:lane + 1].cpu(),
            reserve=grid.rules.reserve[lane:lane + 1].cpu(), kind=kind)
        t0 = time.perf_counter()
        on_cpu = sweep_state_machine(env.values.cpu(),
                                     grid.budgets[lane:lane + 1].cpu(),
                                     rule_cpu, resolve="torch")
        cpu_wall = time.perf_counter() - t0
        for name, a, b in zip(OUTPUTS, fused, on_cpu):
            require(torch.equal(a[lane].cpu(), b[0]),
                    f"{kind}: lane {lane} {name} differs from the CPU")
        results[kind] = dict(wall=wall, plain_wall=plain_wall, rounds=rounds,
                             fused=fused)
        print(f"[4] {kind}: engine.sweep S={grid.num_scenarios} N={n} C={c}: "
              f"{rounds} rounds, {wall:.3f} s, "
              f"{n * grid.num_scenarios / wall:.4g} events*scenarios/s; "
              f"launches {launches}; torch path on the card bitwise the fused "
              f"path, all six outputs ({plain_wall:.3f} s, "
              f"{torch_counts['segment_partials']} segment_partials "
              f"launches); lane {lane} bitwise the CPU torch path "
              f"({cpu_wall:.1f} s)", flush=True)
        print(sweep.format_delta_table())
        del plain, on_cpu

    # ---- phase 5: the exact replay at full width -------------------------
    exact = {}
    for kind in KINDS:
        second = kind == "second_price"
        engine, grid = engines[kind]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = engine.sweep(grid, method="sequential", record_events=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        require(launches["capped_scan"] == 1,
                f"{kind}: {launches['capped_scan']} capped_scan launches for "
                f"one sequential sweep")
        counted["capped_scan"] += launches["capped_scan"]
        res = seq.results
        require(bool(torch.isfinite(res.final_spend).all())
                and tuple(res.winners.shape) == (grid.num_scenarios, n),
                f"{kind}: the exact replay's outputs are malformed")
        again = sweep_sequential(env.values, grid.budgets, grid.rules)
        require(torch.equal(again.final_spend, res.final_spend)
                and torch.equal(again.cap_times, res.cap_times),
                f"{kind}: a second capped_scan launch gave other bits")
        # the replay is causal: its first PREFIX events are the replay of
        # the first PREFIX events, which the plain version runs on the CPU
        lane = CPU_LANE[kind]
        t0 = time.perf_counter()
        w_cpu, p_cpu, _, cap_cpu = scan_ops.capped_scan(
            env.values[:PREFIX].cpu(), grid.budgets[lane].cpu(),
            grid.rules.multipliers[lane].cpu(), grid.rules.reserve[lane].cpu(),
            second_price=second)
        cpu_wall = time.perf_counter() - t0
        caps = res.cap_times[lane].cpu()
        require(torch.equal(res.winners[lane, :PREFIX].cpu(), w_cpu)
                and torch.equal(res.prices[lane, :PREFIX].cpu(), p_cpu),
                f"{kind}: lane {lane}'s first {PREFIX} sales differ from the "
                f"CPU")
        require(torch.equal(torch.where(caps <= PREFIX, caps, PREFIX + 1),
                            cap_cpu),
                f"{kind}: lane {lane}'s cap times up to {PREFIX} differ from "
                f"the CPU")
        exact[kind] = dict(spend=res.final_spend, caps=res.cap_times,
                           wall=wall)
        print(f"[5] {kind}: exact replay S={grid.num_scenarios} N={n} C={c} "
              f"in one capped_scan launch: {wall:.4f} s, "
              f"{n * grid.num_scenarios / wall:.4g} events*scenarios/s; "
              f"a second launch gives the same bits; lane {lane}'s first "
              f"{PREFIX} events bitwise the CPU ({cpu_wall:.1f} s)",
              flush=True)
        del seq, res, again

    # ---- phase 6: three back-ends, one answer ----------------------------
    sr_wall = {}
    for kind in KINDS:
        engine, grid = engines[kind]
        fused = results[kind]["fused"]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                  resolve="sweep_resolve")
        torch.cuda.synchronize()
        sr_wall[kind] = time.perf_counter() - t0
        launches = read_counts()
        rounds = int(out[4].max())
        require(launches["sweep_resolve"] == rounds,
                f"{kind}: {launches['sweep_resolve']} sweep_resolve launches "
                f"for {rounds} rounds")
        require(launches["segment_partials"] == 2 * rounds,
                f"{kind}: {launches['segment_partials']} segment_partials "
                f"launches for {rounds} rounds")
        counted["sweep_resolve"] += launches["sweep_resolve"]
        counted["segment_partials"] += launches["segment_partials"]
        for name, a, b in zip(OUTPUTS, out, fused):
            require(torch.equal(a, b), f"{kind}: the sweep_resolve back-end's "
                                       f"{name} differs from the fused one's")
        rule0, budgets0 = scenario_rule(grid.rules, 0), grid.budgets[0]
        for resolve in RESOLVES:
            one = engine.simulate(rule0, budgets0, method="parallel",
                                  resolve=resolve)
            require(torch.equal(one.final_spend, fused[0][0])
                    and torch.equal(one.cap_times, fused[1][0]),
                    f"{kind}: engine.simulate(resolve={resolve!r}) differs "
                    f"from lane 0 of the sweep")
        print(f"[6] {kind}: torch, sweep_resolve and fused back-ends give "
              f"identical outputs; sweep_resolve sweep {rounds} rounds in "
              f"{sr_wall[kind]:.4f} s, launches {launches}; "
              f"engine.simulate of lane 0 equals lane 0 for all three",
              flush=True)

    # ---- phase 7: the paper's comparison ---------------------------------
    for kind in KINDS:
        engine, grid = engines[kind]
        alg2, oracle = results[kind]["fused"], exact[kind]
        s_par, s_seq = alg2[0].double().cpu(), oracle["spend"].double().cpu()
        rel = ((s_par - s_seq).abs() / s_seq.clamp(min=1e-9)).mean(-1)
        c_par = torch.clamp(alg2[1].cpu().long(), max=n + 1)
        c_seq = torch.clamp(oracle["caps"].cpu().long(), max=n + 1)
        shift = (c_par - c_seq).abs().double().mean(-1)
        print(f"[7] {kind}: Algorithm 2 against the exact replay, per lane "
              f"(mean relative spend error | capped: Alg. 2, exact | mean "
              f"cap-time shift in events)")
        for lane in range(grid.num_scenarios):
            print(f"    {lane:2d} {grid.labels[lane]:<26} "
                  f"{float(rel[lane]):.6f} | {int((c_par[lane] <= n).sum()):3d}"
                  f" {int((c_seq[lane] <= n).sum()):3d} | "
                  f"{float(shift[lane]):.1f}")
        worst = int(rel.argmax())
        require(float(rel.max()) < ORACLE_TOL,
                f"{kind}: lane {worst} has mean relative spend error "
                f"{float(rel.max()):.4f} >= {ORACLE_TOL}")
        walls = (results[kind]["wall"], sr_wall[kind], oracle["wall"])
        print(f"[7] {kind}: worst lane error {float(rel.max()):.6f}; wall: "
              f"Algorithm 2 fused {walls[0]:.4f} s, sweep_resolve "
              f"{walls[1]:.4f} s, exact replay {walls[2]:.4f} s; "
              + ", ".join(f"{n * grid.num_scenarios / w:.4g}" for w in walls)
              + " events*scenarios/s", flush=True)

    # ---- phase 8: SORT2AGGREGATE -------------------------------------------
    plain_index_add = torch.Tensor.index_add_
    index_adds = [0]

    def counting_index_add(self, *a, **k):
        index_adds[0] += 1
        return plain_index_add(self, *a, **k)

    def driven(fn):
        """``fn()`` run with every kernel count and a count of index_add_
        calls set to 0 just before; returns ``(result, wall seconds, kernel
        counts, index_add_ calls)``."""
        reset_counts()
        index_adds[0] = 0
        torch.Tensor.index_add_ = counting_index_add
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.Tensor.index_add_ = plain_index_add
        return out, wall, read_counts(), index_adds[0]

    def same_s2a(a, b, what):
        for name in ("final_spend", "cap_times"):
            require(torch.equal(getattr(a, name).cpu(),
                                getattr(b, name).cpu()),
                    f"{what}: {name} differs")

    def same_s2a_sweep(a, b, what):
        same_s2a(a.results, b.results, what)
        require(torch.equal(a.consistency_gaps.cpu(), b.consistency_gaps.cpu())
                and torch.equal(a.refine_iters.cpu(), b.refine_iters.cpu()),
                f"{what}: consistency gaps or refine iterations differ")

    s2a = {}
    s2a_peak = 0
    refine_iters = 8                      # engine.sweep's default
    for kind in KINDS:
        engine, grid = engines[kind]
        s = grid.num_scenarios
        torch.cuda.reset_peak_memory_stats()
        sim, sim_wall, sim_counts, sim_adds = driven(engine.simulate)
        sweep, sweep_wall, sweep_counts, sweep_adds = driven(
            lambda: engine.sweep(grid, method="sort2aggregate"))
        s2a_peak = max(s2a_peak, torch.cuda.max_memory_allocated())
        for what, cnt, adds in (("simulate", sim_counts, sim_adds),
                                ("sweep", sweep_counts, sweep_adds)):
            others = {k: v for k, v in cnt.items() if v and k not in (
                "auction_resolve", "first_crossing")}
            require(cnt["auction_resolve"] > 0 and cnt["first_crossing"] > 0
                    and not others,
                    f"{kind} S2A {what}: launches {cnt}, expected only "
                    f"auction_resolve and first_crossing")
            require(adds == 0, f"{kind} S2A {what} made {adds} index_add_ "
                               f"calls")
            counted["auction_resolve"] += cnt["auction_resolve"]
            counted["first_crossing"] += cnt["first_crossing"]
        # the sweep = the base design's simulate (its warm start), then
        # refine_iters + 1 passes of S resolves and one crossing launch
        passes = refine_iters + 1
        require(sweep_counts["first_crossing"]
                == sim_counts["first_crossing"] + passes
                and sweep_counts["auction_resolve"]
                == sim_counts["auction_resolve"] + passes * s,
                f"{kind}: S2A sweep launches {sweep_counts} against "
                f"simulate's {sim_counts}")
        res = sweep.results
        require(bool(torch.isfinite(res.final_spend).all())
                and tuple(res.final_spend.shape) == (s, c)
                and bool((res.final_spend >= 0).all())
                and tuple(res.cap_times.shape) == (s, c),
                f"{kind}: S2A sweep outputs malformed")
        # the same again: the same bits
        same_s2a(engine.simulate(), sim, f"{kind} second S2A simulate")
        same_s2a_sweep(engine.sweep(grid, method="sort2aggregate"), sweep,
                       f"{kind} second S2A sweep")
        # Algorithm 4 alone, as simulate runs it (the default key and VI)
        vi_est, vi_wall, _, _ = driven(lambda: vi_lib.estimate_pi(
            env.values, env.budgets, engine.base_rule, prng.PRNGKey(0),
            sample_size=max(int(round(n * 0.01)), 64), num_iters=20,
            batch_size=64))
        # the reduced size: the card's bits are the CPU's
        outs = []
        t0 = time.perf_counter()
        for device in (dev, torch.device("cpu")):
            base_small = AuctionRule(
                multipliers=torch.ones(small.n_campaigns, device=device),
                reserve=torch.zeros((), device=device), kind=kind)
            eng = CounterfactualEngine(small.values, small.budgets,
                                       base_rule=base_small, device=device)
            outs.append((eng.simulate(), eng.sweep(
                eng.grid(**SMALL_AXES), method="sort2aggregate")))
        small_wall = time.perf_counter() - t0
        same_s2a(outs[0][0], outs[1][0], f"{kind} S2A simulate card vs CPU")
        same_s2a_sweep(outs[0][1], outs[1][1], f"{kind} S2A sweep card vs "
                                               f"CPU")
        s2a[kind] = dict(sim_wall=sim_wall, sweep_wall=sweep_wall,
                         vi_wall=vi_wall, sweep=sweep,
                         launches=(sim_counts, sweep_counts))
        print(f"[8] {kind}: S2A engine.simulate() {sim_wall:.4f} s "
              f"(launches {sim_counts}); engine.sweep(method="
              f"'sort2aggregate') S={s} {sweep_wall:.4f} s (launches "
              f"{sweep_counts}); Algorithm 4 alone {vi_wall:.4f} s; no "
              f"index_add_; a second run gives the same bits; at "
              f"N={small.n_events} C={small.n_campaigns} S=8 the card is "
              f"bitwise the CPU ({small_wall:.1f} s)", flush=True)
        print(sweep.format_delta_table())
        # accuracy against phase 5's exact replay
        oracle = exact[kind]
        s_hat, s_ref = res.final_spend.cpu(), oracle["spend"].cpu()
        rel = ((s_hat.double() - s_ref.double()).abs()
               / s_ref.double().clamp(min=1e-9)).mean(-1)
        swe = torch.stack([spend_weighted_relative_error(s_hat[k], s_ref[k])
                           for k in range(s)])
        c_s2a = torch.clamp(res.cap_times.cpu().long(), max=n + 1)
        c_seq = torch.clamp(oracle["caps"].cpu().long(), max=n + 1)
        print(f"[8] {kind}: SORT2AGGREGATE against the exact replay, per "
              f"lane (mean relative spend error | spend-weighted error | "
              f"capped: S2A, exact | cap times equal | consistency gap | "
              f"refine iterations used)")
        for k in range(s):
            print(f"    {k:2d} {grid.labels[k]:<26} {float(rel[k]):.6f} | "
                  f"{float(swe[k]):.6f} | {int((c_s2a[k] <= n).sum()):3d} "
                  f"{int((c_seq[k] <= n).sum()):3d} | "
                  f"{int((c_s2a[k] == c_seq[k]).sum()):3d} | "
                  f"{float(sweep.consistency_gaps[k]):.0f} | "
                  f"{int(sweep.refine_iters[k])}")
        # a lane whose replayed crossings reproduce its assumed cap times
        # (consistency gap 0) holds a self-consistent segment history: the
        # exact replay's, up to the float order of the crossing sums
        converged = sweep.consistency_gaps.cpu() == 0
        if bool(converged.any()):
            worst = float(swe[converged].max())
            require(worst < S2A_TOL,
                    f"{kind}: a lane with consistency gap 0 has "
                    f"spend-weighted error {worst:.4f} >= {S2A_TOL}")
        sim_err = float(spend_weighted_relative_error(sim.final_spend.cpu(),
                                                      s_ref[0]))
        print(f"[8] {kind}: {int(converged.sum())} of {s} lanes converged "
              f"(gap 0); worst lane spend-weighted error "
              f"{float(swe.max()):.6f}, worst mean relative error "
              f"{float(rel.max()):.6f}; engine.simulate() of the base design "
              f"(lane 0): spend-weighted error {sim_err:.6f}", flush=True)
        del outs, sweep, res

    # ---- phase 9: numbers ------------------------------------------------
    # one traced fused sweep and one traced SORT2AGGREGATE simulate (first
    # price): device busy time by kernel
    from torch.profiler import ProfilerActivity, profile
    engine, grid = engines[KINDS[0]]

    def trace(label, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        by_kernel = sorted(
            ((e.key, e.self_device_time_total) for e in prof.key_averages()
             if e.self_device_time_total > 0), key=lambda kv: -kv[1])
        busy_us = sum(us for _, us in by_kernel)
        if busy_us > 0:
            print(f"[9] traced {label}: wall {traced_wall:.4f} s, device "
                  f"busy {busy_us / 1e6:.4f} s, idle share "
                  f"{1 - busy_us / 1e6 / traced_wall:.4f}")
            for key, us in by_kernel[:6]:
                print(f"    {us / 1e3:12.3f} ms  {key[:90]}")
        else:
            print(f"[9] traced {label}: the profiler recorded no device "
                  f"time; device busy share not measured")

    trace("fused sweep", lambda: sweep_state_machine(
        env.values, grid.budgets, grid.rules, resolve="fused"))
    trace("S2A simulate", engine.simulate)
    # the exact replay of the full day, 32 lanes, first price: the kernel,
    # then its plain version over the first PLAIN_EVENTS events (a chain of
    # small launches per event; the full day would take many minutes),
    # which must give the kernel's first PLAIN_EVENTS sales bit for bit
    s = grid.num_scenarios
    scan_args = (grid.budgets, grid.rules.multipliers, grid.rules.reserve)
    scan_ms = cuda_ms(lambda: scan_ops.capped_scan(env.values, *scan_args),
                      3)
    kernel_out = scan_ops.capped_scan(env.values, *scan_args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_out = capped_scan_ref(env.values[:PLAIN_EVENTS], *scan_args)
    stop.record()
    stop.synchronize()
    timing["capped_scan"] = (scan_ms, start.elapsed_time(stop), None)
    for name, a, b in zip(("winners", "prices"), kernel_out, plain_out):
        equal(name, a[:, :PLAIN_EVENTS], b, "capped_scan full day")
    del kernel_out, plain_out
    timing["capped_scan_bound"] = bound_ms(
        n * c * 4 + s * c * 12 + s * 4 + s * n * 8 + s * c * 8, s * n * c * 3)
    print(f"[9] capped_scan, full day, S={s}: {scan_ms:.4f} ms "
          f"({scan_ms * 1e6 / n:.2f} ns per event of the lane chains); the "
          f"plain version {timing['capped_scan'][1]:.1f} ms for the first "
          f"{PLAIN_EVENTS} events, bitwise the kernel; SM clock now "
          f"{smi('clocks.sm')}")
    print(card)
    rm = timing["round_ms"]
    print(f"[9] per-round time from the fresh state, S=32 (CUDA events, "
          f"median): fused {rm['fused']:.4f} ms, sweep_resolve "
          f"{rm['sweep_resolve']:.4f} ms, torch path {rm['torch']:.4f} ms")
    for kind, r in results.items():
        print(f"[9] sweep {kind}: wall {r['wall']:.4f} s, "
              f"{n * 32 / r['wall']:.6g} events*scenarios/s, "
              f"{r['rounds']} rounds; torch path wall {r['plain_wall']:.4f} s;"
              f" sweep_resolve wall {sr_wall[kind]:.4f} s; exact replay wall "
              f"{exact[kind]['wall']:.4f} s")
    print(f"[9] peak device memory in a full-width sweep: fused "
          f"{peak['fused'] / 2**30:.3f} GiB, torch path "
          f"{peak['torch'] / 2**30:.3f} GiB")
    for kind, r in s2a.items():
        print(f"[9] SORT2AGGREGATE {kind}: simulate {r['sim_wall']:.4f} s, "
              f"sweep S=32 {r['sweep_wall']:.4f} s "
              f"({n * 32 / r['sweep_wall']:.6g} events*scenarios/s); "
              f"Algorithm 4 alone {r['vi_wall']:.4f} s, "
              f"{r['vi_wall'] / r['sim_wall']:.4f} of simulate and "
              f"{r['vi_wall'] / r['sweep_wall']:.4f} of the sweep")
    print(f"[9] peak device memory in the SORT2AGGREGATE runs: "
          f"{s2a_peak / 2**30:.3f} GiB")
    emb_ms, emb_plain = timing["auction_resolve_emb"]
    emb_bound, emb_by = timing["auction_resolve_emb_bound"]
    print(f"[9] auction_resolve EmbTile (N={n}, C={c}, "
          f"d={env.event_emb.shape[1]}, (C,) mask, with sums): "
          f"{emb_ms:.4f} ms, plain {emb_plain:.4f} ms, bound "
          f"{emb_bound:.4f} ms ({emb_by}); the JSON line's auction_resolve "
          f"row is MatrixTile at an aggregate pass's shape")
    rows = []
    for name, src, replaces in KERNELS:
        ms, plain_ms, library_ms = timing[name]
        bound, bound_by = timing[f"{name}_bound"]
        print(f"[9] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms if library_ms is None else f'{library_ms:.4f}'}"
              f" ms, bound {bound:.4f} ms ({bound_by}), "
              f"{counted[name]} launches on its path")
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=counted[name],
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by,
                         library_ms=library_ms,
                         plain_events=PLAIN_EVENTS if name == "capped_scan"
                         else n))
        require(counted[name] > 0, f"{name} never launched on its path")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
