"""``repro``'s side of ``tests/test_torch_dryrun.py``, run in its own
process: ``XLA_FLAGS`` must force the host devices before ``jax`` loads,
and ``repro.launch.dryrun`` sets them at import.

  python tests/torch_dryrun_reference.py CELLS_JSON

``CELLS_JSON`` lists ``[name, arch, kind, mesh_shape, batch, seq,
microbatches]``. Each cell is ``repro``'s reduced config lowered as its
dry run lowers it (``runtime.sharding_ctx`` with ``rules_for(arch)``,
``.lower(...).compile()`` on a ``("data", "model")`` mesh of forced host
devices). Prints one JSON object: per cell the product FLOPs of one
device (every ``dot`` and ``convolution`` of the optimized HLO, FLOPs by
``repro.launch.hlo_cost``'s own formula, scaled by the trip counts of the
loops around them), the products by shape, and ``hlo_cost.analyze``'s
totals; and the dry run's ``ARCH_RULES`` and ``ARCH_MICROBATCHES``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import collections  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.devices()      # the backend starts with 4 devices, whatever comes next

from repro.configs import reduced_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import dryrun, hlo_cost  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import build_model, runtime  # noqa: E402
from repro.models import spec as spec_lib  # noqa: E402
from repro.train.optimizer import AdamW, warmup_cosine  # noqa: E402
from repro.train.train_step import make_train_step, state_specs  # noqa: E402


def products(text: str):
    """Per-device dot/convolution FLOPs of an optimized HLO module, each
    scaled by the trip counts of the while loops around it."""
    comps = hlo_cost.parse_module(text)
    entry = next(hlo_cost._COMP_HDR_RE.match(line.strip()).group(1)
                 for line in text.splitlines() if line.startswith("ENTRY"))
    found = collections.Counter()

    def walk(name, mult):
        comp = comps[name]
        for ins in comp.instrs:
            if ins.op == "while":
                body = hlo_cost._BODY_RE.search(ins.rest).group(1)
                m = re.search(r'known_trip_count[":{\s]+n["\s:]+"?(\d+)',
                              ins.rest)
                trips = int(m.group(1)) if m else hlo_cost._trip_count(
                    comps[hlo_cost._COND_RE.search(ins.rest).group(1)])
                walk(body, mult * max(trips, 1))
            elif ins.op in ("fusion", "call", "custom-call", "conditional",
                            "async-start"):
                m = hlo_cost._CALLS_RE.search(ins.rest)
                if m and m.group(1) in comps:
                    walk(m.group(1), mult)
                mb = hlo_cost._BRANCHES_RE.search(ins.rest)
                if mb:
                    for br in re.findall(r"%?([\w\.\-]+)", mb.group(1)):
                        if br in comps:
                            walk(br, mult)
            elif ins.op in ("dot", "convolution"):
                shape = ins.rtype.split("{")[0]
                found[(ins.op, shape, hlo_cost._dot_flops(comp, ins))] += mult

    walk(entry, 1)
    return found


def lower(arch, kind, mesh_shape, b, s, mb):
    cfg = reduced_config(arch)
    model = build_model(cfg)
    shape = ShapeConfig("cell", s, b, kind)
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))
    rules = dryrun.rules_for(arch)
    batch = spec_lib.tree_abstract(model.batch_specs(shape), mesh, rules)
    with mesh, runtime.sharding_ctx(mesh, rules):
        if kind == "train":
            opt = AdamW(learning_rate=warmup_cosine(3e-4, 200, 10_000))
            step = make_train_step(model, opt, microbatches=mb)
            state = spec_lib.tree_abstract(state_specs(model), mesh, rules)
            lowered = jax.jit(step).lower(state, batch)
        elif kind == "prefill":
            params = spec_lib.tree_abstract(model.param_specs(), mesh, rules)
            lowered = jax.jit(lambda p, bt: model.prefill(
                p, bt, max_len=s)).lower(params, batch)
        else:
            params = spec_lib.tree_abstract(model.param_specs(), mesh, rules)
            caches = spec_lib.tree_abstract(model.cache_specs(b, s), mesh,
                                            rules)
            tokens = jax.ShapeDtypeStruct(
                (b, 1), jnp.int32, sharding=jax.NamedSharding(
                    mesh, spec_lib.partition_spec(("batch", "seq"), (b, 1),
                                                  mesh, rules)))
            lowered = jax.jit(model.decode_step).lower(
                params, caches, tokens, jax.ShapeDtypeStruct((), jnp.int32))
    return lowered.compile().as_text()


def main():
    out = {"cells": {},
           "arch_rules": {k: {r: (list(v) if isinstance(v, tuple) else v)
                              for r, v in d.items()}
                          for k, d in dryrun.ARCH_RULES.items()},
           "arch_microbatches": dict(dryrun.ARCH_MICROBATCHES)}
    for name, arch, kind, mesh_shape, b, s, mb in json.loads(sys.argv[1]):
        text = lower(arch, kind, mesh_shape, b, s, mb)
        found = products(text)
        cost = hlo_cost.analyze(text)
        out["cells"][name] = {
            "product_flops": sum(f * n for (_, _, f), n in found.items()),
            "products": [[op, shape, f, n] for (op, shape, f), n
                         in sorted(found.items())],
            "flops": cost.flops, "bytes": cost.bytes}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
