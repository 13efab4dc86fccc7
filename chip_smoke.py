#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   paper's §7.1 width (N=1,000,000 events, C=100 campaigns, S=32 designs),
   from a fresh and from a mid-day sweep state, under both pricing rules;
3. hold the fused-round sweep on the card against the plain torch sweep on
   the CPU at a reduced size (N=65,536, C=64, S=8): every integer output
   equal, spends at rtol 1e-6;
4. run the main path, ``CounterfactualEngine.sweep(grid,
   method="parallel")`` with ``resolve="auto"``, at full width for both
   pricing rules; the launch counters show it went through the kernels, a
   second run must give the same bits, and the torch path on the card must
   agree within tolerance;
5. print the numbers: the card's name and power limit, per-round and sweep
   times, peak memory, and one JSON line describing each kernel.

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
KINDS = ("first_price", "second_price")


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


def partials_cost(values, n_scenarios, window_rows, second_price, outputs):
    """Bytes and operations of partials passes: the valuation rows read
    once, the (S, C) lane inputs, the outputs written once; a multiply and
    a compare per (lane, row, campaign) in the windows (a second compare
    for second price)."""
    n, c = values.shape
    n_bytes = n * c * 4 + n_scenarios * (c * 5 + 16) + outputs
    n_ops = window_rows * c * (3 if second_price else 2)
    return n_bytes, n_ops


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

    from repro_torch.configs.paper_auction import (PAPER_SYNTHETIC_CPU,
                                                   PAPER_SYNTHETIC_FULL)
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, sweep_state_machine)
    from repro_torch.core import executor
    from repro_torch.core.segments import REDUCE_BLOCKS
    from repro_torch.data import make_synthetic_env
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import ops, ref
    from repro_torch.kernels.auction_resolve import round_fused as kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- phase 1: build --------------------------------------------------
    lib_path, log, seconds = build.build("round_fused")
    print(f"[1] built {lib_path.name} in {seconds:.2f} s", flush=True)
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    # ---- phase 2: kernels vs plain versions at full width ---------------
    full = PAPER_SYNTHETIC_FULL
    t0 = time.perf_counter()
    env = make_synthetic_env(args.seed, full.n_events, full.n_campaigns,
                             full.emb_dim, b_base=full.b_base, device=dev)
    torch.cuda.synchronize()
    n, c = env.values.shape
    block = -(-n // REDUCE_BLOCKS)
    print(f"[2] env N={n} C={c}: values {env.values.numel() * 4 / 1e6:.0f} "
          f"MB on the card, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    gen = torch.Generator().manual_seed(args.seed + 1)
    errs = {"round_fused": 0.0, "sweep_partials": 0.0}

    def close(name, got, want, mask=None):
        if mask is not None:
            got, want = got[mask], want[mask]
        tol = 1e-6 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        errs[name] = max(errs[name], float((got - want).abs().max()))

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

    timing = {}
    for kind in KINDS:
        second = kind == "second_price"
        base = AuctionRule(multipliers=torch.ones(c, device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        grid = ScenarioGrid.product(base, env.budgets, **GRID_AXES)
        s = grid.num_scenarios
        ones = torch.ones((s, c), dtype=torch.bool, device=dev)
        zeros = torch.zeros((s, c), device=dev)
        n0 = torch.zeros(s, dtype=torch.int32, device=dev)
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
        got = ops.sweep_partials(v_slice, grid.rules.multipliers, active,
                                 grid.rules.reserve, lo, hi, all_alive,
                                 offset, n_events_global=n,
                                 reduce_blocks=REDUCE_BLOCKS,
                                 second_price=second)
        want = ref.fused_partials_ref(v_slice, grid.rules.multipliers,
                                      active, grid.rules.reserve, lo, hi,
                                      block_size=block, second_price=second,
                                      index_offset=offset)
        close("sweep_partials", got, want)
        print(f"[2] {kind}: round (fresh, mid-day) and offset partials "
              f"agree with the plain versions", flush=True)
        if kind == "first_price":
            # time the fresh-state round and one full-window pass
            args_rf = (env.values, grid.rules.multipliers, ones,
                       grid.rules.reserve, grid.budgets, zeros, n0,
                       all_alive)
            full_hi = torch.full_like(n0, n)
            timing["round_fused"] = (
                cuda_ms(lambda: ops.round_fused(
                    *args_rf, reduce_blocks=REDUCE_BLOCKS), 10),
                cuda_ms(lambda: ref.round_fused_ref(
                    *args_rf[:7], block_size=block), 3))
            timing["sweep_partials"] = (
                cuda_ms(lambda: ops.sweep_partials(
                    env.values, grid.rules.multipliers, ones,
                    grid.rules.reserve, n0, full_hi, all_alive,
                    n_events_global=n, reduce_blocks=REDUCE_BLOCKS), 10),
                cuda_ms(lambda: ref.fused_partials_ref(
                    env.values, grid.rules.multipliers, ones,
                    grid.rules.reserve, n0, full_hi, block_size=block), 3))
            out_bytes = s * REDUCE_BLOCKS * c * 4
            rows_rate = s * n
            rows_block = int(fresh[4].sum())
            timing["round_fused_bound"] = bound_ms(*partials_cost(
                env.values, s, rows_rate + rows_block, False,
                2 * out_bytes + 9 * s))
            timing["sweep_partials_bound"] = bound_ms(*partials_cost(
                env.values, s, rows_rate, False, out_bytes))
            round_bodies = {}
            for resolve in ("fused", "torch"):
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
                                                 (10, 3))}

    # ---- phase 3: exactness at a reduced size ----------------------------
    small_cfg = PAPER_SYNTHETIC_CPU
    small = make_synthetic_env(args.seed, small_cfg.n_events,
                               small_cfg.n_campaigns, small_cfg.emb_dim,
                               b_base=small_cfg.b_base, device=dev)
    for kind in KINDS:
        base = AuctionRule(
            multipliers=torch.ones(small.n_campaigns, device=dev),
            reserve=torch.zeros((), device=dev), kind=kind)
        grid = ScenarioGrid.product(base, small.budgets, bid_scales=(1.0, 1.2),
                                    reserves=(0.0, 0.05),
                                    budget_scales=(1.0, 0.5))
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
        names = ("final_spend", "cap_times", "retired", "boundaries",
                 "num_rounds", "n_hat")
        for name, a, b in zip(names[1:], on_card[1:], on_cpu[1:]):
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
    counted = {"round_fused": 0, "sweep_partials": 0}
    peak = {"fused": 0, "torch": 0}
    cpu_lane = {"first_price": 0, "second_price": 31}
    for kind in KINDS:
        base = AuctionRule(multipliers=torch.ones(c, device=dev),
                           reserve=torch.zeros((), device=dev), kind=kind)
        engine = CounterfactualEngine(env.values, env.budgets, base_rule=base)
        grid = engine.grid(**GRID_AXES)
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sweep = engine.sweep(grid, method="parallel")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak["fused"] = max(peak["fused"], torch.cuda.max_memory_allocated())
        for name in counted:
            counted[name] += launches[name]
        spend, caps = sweep.results.final_spend, sweep.results.cap_times
        require(bool(torch.isfinite(spend).all())
                and tuple(spend.shape) == (grid.num_scenarios, c)
                and bool((spend >= 0).all()),
                f"{kind}: spends not finite, negative or of the wrong shape")
        # the same sweep again: the kernels are deterministic
        again = sweep_state_machine(env.values, grid.budgets, grid.rules)
        rounds = int(again[4].max())
        require(launches["round_fused"] == rounds,
                f"{kind}: {launches['round_fused']} round_fused launches for "
                f"{rounds} rounds")
        require(launches["sweep_partials"] == 2 * rounds,
                f"{kind}: {launches['sweep_partials']} partials launches for "
                f"{rounds} rounds")
        require(torch.equal(spend, again[0]) and torch.equal(caps, again[1]),
                f"{kind}: a second fused sweep gave other bits")
        # the plain torch path on the card, one lane at a time
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                    resolve="torch")
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        peak["torch"] = max(peak["torch"], torch.cuda.max_memory_allocated())
        # The torch path on the card sums with atomics, so its partials and
        # spends differ from the kernel's event-ordered sums in the last
        # bits. Algorithm 2 turns that into a different boundary wherever
        # a floor(time-to-live) sits near an integer, and from there on the
        # lane replays other blocks and its cap times move. Lanes that
        # replay the same rounds must agree to rtol 1e-4; the others are
        # reported. (Exactness is checked against the CPU below, where the
        # plain version sums in event order as the kernel does.)
        f_ret, f_bnd = again[2], again[3][:, 1:]
        p_ret, p_bnd = plain[2], plain[3][:, 1:]
        same_round = (f_ret == p_ret) & (f_bnd == p_bnd)       # (S, C+1)
        diverged = ~same_round.all(-1)
        first = (~same_round).to(torch.int32).argmax(-1)
        lanes = diverged.nonzero()[:, 0]
        gap = (f_bnd[lanes, first[lanes]] - p_bnd[lanes, first[lanes]]).abs()
        torch.testing.assert_close(spend[~diverged], plain[0][~diverged],
                                   rtol=1e-4, atol=1e-3)
        differ = int((caps != plain[1]).sum())
        print(f"[4] {kind}: torch path on the card: {int((~diverged).sum())}"
              f" of {grid.num_scenarios} lanes replay the same rounds (spends "
              f"at rtol 1e-4); the others first differ at rounds "
              f"{first[lanes].tolist()} by {gap.tolist()} event(s); "
              f"{differ} of {caps.numel()} cap times differ", flush=True)
        # one lane at full width against the torch path on the CPU, where
        # index_add_ sums in event order as the kernel does: the same bits
        lane = cpu_lane[kind]
        rule_cpu = AuctionRule(
            multipliers=grid.rules.multipliers[lane:lane + 1].cpu(),
            reserve=grid.rules.reserve[lane:lane + 1].cpu(), kind=kind)
        t0 = time.perf_counter()
        on_cpu = sweep_state_machine(env.values.cpu(),
                                     grid.budgets[lane:lane + 1].cpu(),
                                     rule_cpu, resolve="torch")
        cpu_wall = time.perf_counter() - t0
        for name, a, b in zip(("final_spend", "cap_times", "retired",
                               "boundaries", "num_rounds", "n_hat"),
                              again, on_cpu):
            require(torch.equal(a[lane].cpu(), b[0]),
                    f"{kind}: lane {lane} {name} differs from the CPU")
        results[kind] = dict(wall=wall, plain_wall=plain_wall, rounds=rounds,
                             cap_differ=differ)
        print(f"[4] {kind}: engine.sweep S={grid.num_scenarios} N={n} C={c}: "
              f"{rounds} rounds, {wall:.3f} s, "
              f"{n * grid.num_scenarios / wall:.4g} events*scenarios/s; "
              f"launches {launches}; torch path {plain_wall:.3f} s; lane "
              f"{lane} bitwise the CPU torch path ({cpu_wall:.1f} s)",
              flush=True)
        print(sweep.format_delta_table())

    # ---- phase 5: numbers ------------------------------------------------
    # one traced fused sweep (first price): device busy time by kernel
    from torch.profiler import ProfilerActivity, profile
    base = AuctionRule(multipliers=torch.ones(c, device=dev),
                       reserve=torch.zeros((), device=dev), kind=KINDS[0])
    grid = ScenarioGrid.product(base, env.budgets, **GRID_AXES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep_state_machine(env.values, grid.budgets, grid.rules)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    by_kernel = sorted(
        ((e.key, e.self_device_time_total) for e in prof.key_averages()
         if e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy_us = sum(us for _, us in by_kernel)
    if busy_us > 0:
        print(f"[5] traced fused sweep: wall {traced_wall:.4f} s, device "
              f"busy {busy_us / 1e6:.4f} s, idle share "
              f"{1 - busy_us / 1e6 / traced_wall:.4f}")
        for key, us in by_kernel[:6]:
            print(f"    {us / 1e3:12.3f} ms  {key[:90]}")
    else:
        print("[5] traced fused sweep: the profiler recorded no device time; "
              "device busy share not measured")
    print(smi)
    print(f"[5] per-round time from the fresh state, S=32 (CUDA events, "
          f"median): fused {timing['round_ms']['fused']:.4f} ms, torch path "
          f"{timing['round_ms']['torch']:.4f} ms")
    for kind, r in results.items():
        print(f"[5] sweep {kind}: wall {r['wall']:.4f} s, "
              f"{n * 32 / r['wall']:.6g} events*scenarios/s, "
              f"{r['rounds']} rounds; torch path wall {r['plain_wall']:.4f} s")
    print(f"[5] peak device memory in a full-width sweep: fused "
          f"{peak['fused'] / 2**30:.3f} GiB, torch path "
          f"{peak['torch'] / 2**30:.3f} GiB")
    src = "src/repro_torch/csrc/round_fused.cu"
    pallas = "src/repro/kernels/auction_resolve/round_fused.py"
    rows = []
    for name, line in (("round_fused", 197), ("sweep_partials", 301)):
        ms, plain_ms = timing[name]
        bound, bound_by = timing[f"{name}_bound"]
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=f"{pallas}:{line}",
                         launches=counted[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=bound_by, library_ms=None))
        require(counted[name] > 0, f"{name} never launched on the main path")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
