"""Measure how many interleaved multiply-add chains XLA CPU's float32
``(M, K) @ (N, K).T`` kernel keeps, by (N, K): the table behind
``repro_torch.floats.DOT_CHAINS``.

For each K it draws ``a`` (M, K) and ``b`` (N_MAX, K) from numpy seed K,
computes ``jax.jit(lambda a, b: a @ b[:n].T)`` for n = 1 ... N_FULL (many
products to a compiled function, each on its own operands) and compares
each with ``floats.xla_dot`` forced to 1, 2, 4 and 8 chains: the counts
whose bits equal XLA's at every (row, column) are the kernel's (several
where they give the same bits, none where no count does). Past N_FULL it
classifies SAMPLES further N drawn up to N_MAX, and N_MAX itself. It also
checks three products at M = BIG_M rows against the counts found (the
keyed day's blocks are 65,536 rows). It prints one JSON object a K:
``{"k", "codes" (run lengths over n = 1 ... N_FULL, "u*count", "?" for no
match, "1/8" for two that match), "samples" ([n, code] past N_FULL),
"big_m_ok"}``; ``floats.DOT_CHAINS`` extends a K's codes past N_FULL
only where every sample fits a period of its last 512 codes.

  PYTHONPATH=src python tests/measure_dot_chains.py 1 64 > chains.jsonl
  PYTHONPATH=src python tests/measure_dot_chains.py table chains.jsonl

(jax on the CPU; half a minute a K at the defaults.) The second command
prints ``DOT_CHAINS``'s source: a K's run lengths over n = 1 ... N_FULL
("0" where no count matched; the smallest count where several did), then
"|" and, where the last 256 codes repeat with a period that every sample
past N_FULL fits, that period's run lengths over n mod period.
"""
from __future__ import annotations

import json
import sys

import jax
import numpy as np
import torch

from repro_torch import floats

M, N_FULL, N_MAX, SAMPLES, BIG_M = 16, 1024, 16_384, 256, 4096
CANDIDATES = (1, 2, 4, 8)
PER_JIT = 128


def forced(a: np.ndarray, b: np.ndarray, u: int) -> np.ndarray:
    """``floats.xla_dot`` with ``u`` chains whatever the table says."""
    table = floats.dot_chains
    floats.dot_chains = lambda m, n, k: u
    try:
        return floats.xla_dot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    finally:
        floats.dot_chains = table


def xla_products(a: np.ndarray, b: np.ndarray, ns) -> list:
    out = []
    for i in range(0, len(ns), PER_JIT):
        chunk = ns[i:i + PER_JIT]
        fn = jax.jit(lambda x, y, chunk=chunk: [x @ y[:n].T for n in chunk])
        out.extend(np.asarray(r) for r in fn(a, b))
    return out


def classify(cands: dict, got: np.ndarray, n: int) -> str:
    ok = [u for u in CANDIDATES if np.array_equal(cands[u][:, :n], got)]
    if len(ok) == 1:
        return str(ok[0])
    return "?" if not ok else "/".join(map(str, ok))


def run_lengths(values) -> list:
    codes, prev, count = [], None, 0
    for v in values:
        if v == prev:
            count += 1
            continue
        if prev is not None:
            codes.append(f"{prev}*{count}")
        prev, count = v, 1
    codes.append(f"{prev}*{count}")
    return codes


def measure(k: int) -> dict:
    rng = np.random.default_rng(k)
    a = rng.standard_normal((M, k)).astype(np.float32)
    b = rng.standard_normal((N_MAX, k)).astype(np.float32)
    cands = {u: forced(a, b, u) for u in CANDIDATES}
    ns = list(range(1, N_FULL + 1))
    found = [classify(cands, r, n) for n, r in zip(ns, xla_products(a, b, ns))]
    extra = sorted(set(rng.integers(N_FULL + 1, N_MAX + 1,
                                    SAMPLES).tolist()) | {N_MAX})
    samples = [[n, classify(cands, r, n)]
               for n, r in zip(extra, xla_products(a, b, extra))]
    big_ok = []
    big_a = rng.standard_normal((BIG_M, k)).astype(np.float32)
    for n in (100, 1000, 1024):
        u = int(found[n - 1].split("/")[0]) if found[n - 1] != "?" else 1
        got = np.asarray(jax.jit(lambda x, y: x @ y.T)(big_a, b[:n]))
        big_ok.append([n, found[n - 1] != "?"
                       and np.array_equal(forced(big_a, b[:n], u), got)])
    return {"k": k, "codes": run_lengths(found), "samples": samples,
            "big_m_ok": big_ok}


def _expand(codes) -> list:
    out = []
    for code in codes:
        value, count = code.split("*")
        value = "0" if value == "?" else value.split("/")[0]
        out += [value] * int(count)
    return out


def table_entry(row: dict) -> str:
    """One K's ``DOT_CHAINS`` string from its measured row."""
    found = _expand(row["codes"])
    tail = found[-256:]
    period = next((p for p in (1, 16, 32, 64, 128)
                   if all(tail[i] == tail[i % p] for i in range(256))), None)
    unit = None
    if period is not None and "0" not in tail:
        # n = N_FULL - 255 + i holds tail[i]; unit[r] is n mod period = r
        start = N_FULL - 255
        unit = [tail[(r - start) % period] for r in range(period)]
        if not all(unit[n % period] == _expand([f"{c}*1"])[0]
                   for n, c in row["samples"]):
            unit = None
    head = " ".join(run_lengths(found))
    return head + " |" + (" " + " ".join(run_lengths(unit)) if unit else "")


def source_line(k: int, entry: str) -> str:
    """``k: <entry>,`` as Python source within 79 columns, a run of three
    or more repeats of a unit of 2 to 8 codes written as a product."""
    codes, pieces, i = entry.split(" "), [], 0
    while i < len(codes):
        best = (1, 1)
        for width in (2, 4, 6, 8):
            unit, reps = codes[i:i + width], 1
            while len(unit) == width and \
                    codes[i + reps * width:i + (reps + 1) * width] == unit:
                reps += 1
            if reps >= 3 and reps * width > best[0] * best[1]:
                best = (reps, width)
        reps, width = best
        text = " ".join(codes[i:i + width]) + " "
        if reps > 1 or not pieces or pieces[-1][1] > 1 \
                or len(pieces[-1][0]) + len(text) > 60:
            pieces.append([text, reps])
        else:
            pieces[-1][0] += text
        i += reps * width
    pieces[-1][0] = pieces[-1][0][:-1]
    terms = [repr(t) if r == 1 else f"{t!r} * {r}" for t, r in pieces]
    lines, line = [], f"    {k}: "
    for j, term in enumerate(terms):
        piece = term if j == 0 else f" + {term}"
        if len(line) + len(piece) > 77 and j:
            lines.append(line)
            line = f"        + {term}"
        else:
            line += piece
    lines.append(line + ",")
    return "\n".join(lines)


def main(argv) -> None:
    torch.set_num_threads(1)
    if argv[0] == "table":
        rows = sorted((json.loads(line) for line in open(argv[1])),
                      key=lambda r: r["k"])
        for row in rows:
            assert all(ok for _, ok in row["big_m_ok"]), row["k"]
            print(source_line(row["k"], table_entry(row)))
        return
    lo, hi = int(argv[0]), int(argv[1])
    for k in range(lo, hi + 1):
        print(json.dumps(measure(k)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
