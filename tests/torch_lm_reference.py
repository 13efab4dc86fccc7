"""Helpers of the whole-model tests of the port's MoE and recurrent
architectures (``tests/test_torch_moe.py``, ``tests/test_torch_mixers.py``):
``repro``'s serving path run two ways, and the port's, on the same
parameters and prompts. At the end, the same reference for the models
with a stub frontend and for sampling (:class:`ServeReference`, used by
``tests/test_torch_encdec.py`` and ``tests/test_torch_sampling.py``).

* ``repro`` with XLA's excess precision off (``XLA_FLAGS=
  --xla_allow_excess_precision=false``, in a subprocess, since the flag is
  read when XLA starts) and its flash-attention fast path engaged
  (``repro.models.attention.causal_attention`` set to the Pallas kernel,
  run in interpret mode): its jitted prefill and decode steps then round
  every bfloat16 op as the port's eager ops do. Every MoE call's
  probabilities and chosen experts come back through
  ``jax.debug.callback``.
* ``repro``'s ``ServeEngine`` as it is, compiled, in the test's process:
  XLA keeps excess float32 precision inside its fusions.
* the port, following the reference's routing where the two differ at a
  near tie (:func:`port_greedy`, ``repro_torch.models.moe.
  follow_routing``): MoE routing is a discontinuous function of its
  input, and a matmul's accumulation order can move a bfloat16 value by
  one rounding, so an expert whose probability is within that drift of the
  next one's can swap with it. The port takes the reference's experts
  there only if its own probabilities at that token are within
  ``DRIFT_TOL`` of the reference's, and records each such swap;
  everything else is the port's own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.models.spec import ParamSpec
from repro.serve import engine as j_engine
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.models import moe as t_moe
from repro_torch.serve import engine as t_engine

SRC = str(Path(__file__).resolve().parents[1] / "src")
B, S, MAX_LEN, STEPS = 2, 12, 32, 8
DRIFT_TOL = 2.0 ** -7
MODEL_TOL = 3e-2


def rel(port, want) -> float:
    """``max|port - want| / max|want|``."""
    a = np.asarray(want, np.float32)
    b = port.float().numpy() if isinstance(port, torch.Tensor) else \
        np.asarray(port, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


def numpy_params(arch: str, seed: int = 0, n_layers=None) -> dict:
    """``repro``'s parameter tree of ``reduced_config(arch)`` (cut to
    ``n_layers`` if given) drawn with numpy by the reference's
    initialisers (``repro.models.spec``'s ``_init_leaf``; drawing with
    ``jax.random`` compiles one program a leaf shape, ten seconds a
    model)."""
    rng = np.random.default_rng(seed)

    def leaf(spec: ParamSpec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        fan_in = spec.fan_in or (spec.shape[0] if len(spec.shape) >= 2
                                 else spec.shape[-1])
        std = 1.0 if spec.init == "embed" else \
            spec.scale / math.sqrt(max(fan_in, 1))
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)

    cfg = j_reduced_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    specs = j_build_model(cfg).param_specs()
    return jax.tree.map(leaf, specs,
                        is_leaf=lambda x: isinstance(x, ParamSpec))


def prompts(arch: str) -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, reduced_config(arch).vocab_size, (B, S)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.models.attention as j_attention
    from repro.configs import reduced_config
    from repro.kernels.flash_attention import flash_attention
    from repro.models import build_model
    B, S, MAX_LEN, STEPS = %d, %d, %d, %d
    j_attention.causal_attention = flash_attention
    records = []
    top_k = jax.lax.top_k

    def recorded_top_k(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda p, i: records.append(
            (np.asarray(p), np.asarray(i))), x, idx, ordered=True)
        return vals, idx

    jax.lax.top_k = recorded_top_k
    out = {}
    for arch in sys.argv[2:]:
        with np.load(f"{sys.argv[1]}/{arch}.npz") as data:
            flat = {k: data[k] for k in data.files}
        params = {}
        for path, value in flat.items():
            node = params
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(value)
        cfg = reduced_config(arch)
        model = build_model(cfg)
        prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t},
                                                     MAX_LEN))
        decode = jax.jit(model.decode_step)
        records.clear()
        toks = jnp.asarray(flat["__prompts__"])
        logits, caches = prefill(params, toks)
        out[f"{arch}/prefill"] = np.asarray(logits[:, -1:], np.float32)
        tokens = []
        for i in range(STEPS):
            tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1).astype(
                jnp.int32)
            tokens.append(np.asarray(tok))
            logits, caches = decode(params, caches, tok[:, None],
                                    jnp.int32(S + i))
            if i == 0:
                out[f"{arch}/decode"] = np.asarray(logits, np.float32)
        jax.effects_barrier()
        out[f"{arch}/tokens"] = np.stack(tokens, 1)
        for j, (p, i) in enumerate(records):
            out[f"{arch}/probs/{j}"] = p
            out[f"{arch}/experts/{j}"] = i
    np.savez(f"{sys.argv[1]}/reference.npz", **out)
    print("REFERENCE_OK")
""") % (B, S, MAX_LEN, STEPS)


class Reference:
    """``repro`` without excess precision, for ``archs``, started in a
    subprocess at once (:meth:`result` waits for it)."""

    def __init__(self, archs, params: dict, workdir: Path):
        self.workdir = workdir
        for arch in archs:
            np.savez(workdir / f"{arch}.npz", __prompts__=prompts(arch),
                     **_flat(params[arch]))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_allow_excess_precision=false")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE, str(workdir), *archs], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def result(self, arch: str) -> dict:
        if self._out is None:
            stdout, stderr = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, stderr[-3000:]
            assert "REFERENCE_OK" in stdout
            with np.load(self.workdir / "reference.npz") as data:
                self._out = {k: data[k] for k in data.files}
        out = {k.split("/", 1)[1]: v for k, v in self._out.items()
               if k.startswith(f"{arch}/")}
        calls = sum(k.startswith("probs/") for k in out)
        out["routes"] = [(out[f"probs/{j}"], out[f"experts/{j}"])
                         for j in range(calls)]
        return out


def compiled_greedy(arch: str, params: dict) -> tuple:
    """``repro``'s ``ServeEngine`` steps as they are, greedy: (prefill
    logits, first decode logits, tokens)."""
    j_model = j_build_model(j_reduced_config(arch))
    eng = j_engine.ServeEngine(j_model, params, max_len=MAX_LEN)
    vocab = reduced_config(arch).vocab_size
    logits, caches = eng._prefill(params, {"tokens": jnp.asarray(
        prompts(arch))})
    first, out, decode_logits = logits, [], None
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1, :vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, caches = eng._decode(params, caches, tok[:, None],
                                     jnp.int32(S + i))
        decode_logits = logits if decode_logits is None else decode_logits
    return (np.asarray(first[:, -1:], np.float32),
            np.asarray(decode_logits, np.float32), np.stack(out, 1))


def port_greedy(port, arch: str, routes=None) -> tuple:
    """The port's greedy loop: (prefill logits, first decode logits,
    tokens, the near ties where it took ``routes``' experts). With
    ``routes`` (the reference's (probs, experts) of each MoE call), the
    port follows them at near ties (``moe.follow_routing`` with
    ``DRIFT_TOL``, which raises past one)."""
    cfg = port.cfg
    follow = (t_moe.follow_routing(routes, DRIFT_TOL) if routes is not None
              else contextlib.nullcontext([]))
    with follow as ties:
        toks = torch.from_numpy(prompts(arch)).long()
        first, caches = port.prefill(toks, MAX_LEN)
        logits, out, decode_logits = first, [], None
        for i in range(STEPS):
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)
            out.append(tok.numpy().astype(np.int32))
            logits, caches = port.decode_step(caches, tok[:, None], S + i)
            decode_logits = logits if decode_logits is None \
                else decode_logits
    return (first.float().numpy(), decode_logits.float().numpy(),
            np.stack(out, 1), ties)


def serve_both(arch: str, params: dict, reference: Reference) -> dict:
    """Everything the whole-model tests of ``arch`` compare."""
    port = interop.lm_params_from_reference(params, reduced_config(arch),
                                            device="cpu")
    compiled = compiled_greedy(arch, params)
    own = port_greedy(port, arch)
    engine_tokens = t_engine.ServeEngine(port, max_len=MAX_LEN).generate(
        torch.from_numpy(prompts(arch)).long(), STEPS).numpy()
    ref = reference.result(arch)
    handed = port_greedy(port, arch, ref["routes"])
    if handed[3]:
        print(f"{arch}: near ties where the port took repro's experts: "
              f"{handed[3]}")
    return dict(arch=arch, cfg=reduced_config(arch), port=handed[:3],
                ties=handed[3], own=own, engine_tokens=engine_tokens,
                ref=(ref["prefill"], ref["decode"], ref["tokens"]),
                routes=ref["routes"], compiled=compiled)


def check_model(served: dict) -> None:
    """The port's logits within ``MODEL_TOL`` of ``repro``'s without
    excess precision and its greedy tokens equal; its engine's tokens its
    own loop's."""
    cfg = served["cfg"]
    prefill, decode, tokens = served["port"]
    assert prefill.shape == (B, 1, cfg.padded_vocab)
    assert decode.shape == (B, 1, cfg.padded_vocab)
    assert rel(prefill, served["ref"][0]) < MODEL_TOL, served["arch"]
    assert rel(decode, served["ref"][1]) < MODEL_TOL, served["arch"]
    assert np.array_equal(tokens, served["ref"][2]), served["arch"]
    assert np.array_equal(served["engine_tokens"], served["own"][2])
    if not served["ties"]:
        assert np.array_equal(served["own"][2], tokens)


def check_compiled(served: dict) -> None:
    """The port is as close to ``repro``'s compiled run as ``repro``'s
    own run without excess precision is, within ``MODEL_TOL``."""
    for i, what in enumerate(("prefill", "decode")):
        port, ref = served["port"][i], served["ref"][i]
        compiled = served["compiled"][i]
        assert rel(port, compiled) <= rel(ref, compiled) + MODEL_TOL, \
            (served["arch"], what)


# ---------------------------------------------------------------------------
# serving with the stub frontends (whisper's frames, internvl2's patches)
# and at temperature > 0: ``tests/test_torch_encdec.py`` and
# ``tests/test_torch_sampling.py``

SERVE_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.models.attention as j_attention
    from repro.configs import reduced_config
    from repro.kernels.flash_attention import flash_attention
    from repro.models import build_model
    from repro.serve.engine import ServeEngine
    MAX_LEN, STEPS = %d, %d
    j_attention.causal_attention = flash_attention
    out = {}
    for job in json.loads(sys.argv[2]):
        name, arch = job["name"], job["arch"]
        with np.load(f"{sys.argv[1]}/{name}.npz") as data:
            flat = {k: data[k] for k in data.files}
        params, batch = {}, {}
        for path, value in flat.items():
            if path.startswith("batch/"):
                batch[path[6:]] = jnp.asarray(value)
                continue
            node = params
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(value)
        cfg = reduced_config(arch)
        model = build_model(cfg)
        if job["greedy"]:
            prefill = jax.jit(lambda p, b: model.prefill(p, b, MAX_LEN))
            decode = jax.jit(model.decode_step)
            logits, caches = prefill(params, batch)
            out[f"{name}/logits/0"] = np.asarray(logits[:, -1:], np.float32)
            stack = "dec_groups" if cfg.is_encdec else "groups"
            for j, layer in enumerate(caches[stack].values()):
                if cfg.is_encdec:
                    kv = dict(k=layer.self_kv.k, v=layer.self_kv.v,
                              cross_k=layer.cross_k, cross_v=layer.cross_v)
                else:
                    kv = dict(k=layer["sub0"].k, v=layer["sub0"].v)
                for key, value in kv.items():
                    out[f"{name}/caches/{j}/{key}"] = np.asarray(
                        value, np.float32)
            start = batch["tokens"].shape[1] + cfg.num_patches
            tokens = []
            for i in range(STEPS):
                tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1).astype(
                    jnp.int32)
                tokens.append(np.asarray(tok))
                logits, caches = decode(params, caches, tok[:, None],
                                        jnp.int32(start + i))
                out[f"{name}/logits/{i + 1}"] = np.asarray(logits,
                                                           np.float32)
            out[f"{name}/tokens"] = np.stack(tokens, 1)
        for t, seed in job["sampled"]:
            eng = ServeEngine(model, params, max_len=MAX_LEN, temperature=t)
            out[f"{name}/sampled/{t}/{seed}"] = np.asarray(eng.generate(
                batch, STEPS, key=jax.random.PRNGKey(seed)))
    np.savez(f"{sys.argv[1]}/reference.npz", **out)
    print("REFERENCE_OK")
""") % (MAX_LEN, STEPS)


def serve_batch(arch: str, seed: int = 1) -> dict:
    """``repro``'s serving batch of ``reduced_config(arch)`` from numpy
    ``seed``: B x S prompt tokens, and the stub frontends' float32
    ``frames`` (B, encoder_frames, d) or ``patch_embeds`` (B, num_patches,
    d), standard normal."""
    cfg = reduced_config(arch)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch: dict) -> dict:
    """The port's batch of :func:`serve_batch`'s (int64 tokens)."""
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


class ServeReference:
    """``repro``'s serving path without excess precision (the flash fast
    path in interpret mode, as :class:`Reference`), started in a
    subprocess at once; :meth:`result` waits for it. ``jobs`` are
    ``(name, arch, params, batch, greedy, sampled)``: ``greedy`` runs the
    jitted prefill and STEPS greedy decode steps (every step's logits,
    the prefill's caches, the tokens); ``sampled`` lists ``(temperature,
    key seed)`` pairs for ``ServeEngine.generate``."""

    def __init__(self, jobs, workdir: Path):
        import json
        self.workdir = workdir
        spec = []
        for name, arch, params, batch, greedy, sampled in jobs:
            np.savez(workdir / f"{name}.npz", **_flat(params),
                     **{f"batch/{k}": v for k, v in batch.items()})
            spec.append(dict(name=name, arch=arch, greedy=greedy,
                             sampled=[list(p) for p in sampled]))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_allow_excess_precision=false")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SERVE_REFERENCE, str(workdir),
             json.dumps(spec)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._out = None

    def result(self, name: str) -> dict:
        if self._out is None:
            stdout, stderr = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, stderr[-3000:]
            assert "REFERENCE_OK" in stdout
            with np.load(self.workdir / "reference.npz") as data:
                self._out = {k: data[k] for k in data.files}
        return {k.split("/", 1)[1]: v for k, v in self._out.items()
                if k.startswith(f"{name}/")}
