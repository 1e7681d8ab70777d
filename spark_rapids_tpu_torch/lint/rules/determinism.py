"""Determinism and dead-code rules (port of
``spark_rapids_tpu/lint/rules/determinism.py``).

* RL-NONDETERMINISM — no wall-clock or unseeded randomness in the
  execs/ and ops/ modules (results must replay bit-identically; LORE
  depends on it): no ``time.time``/``datetime.now``, no process-global
  ``np.random``/``random`` state, and no torch generator that is not an
  explicit seeded ``torch.Generator`` (``torch.rand``/``randn``/
  ``randint``/``randperm``/``manual_seed`` without a ``generator=``).
* RL-DEAD-LAMBDA — a lambda bound to a name that is never referenced
  again is dead code.
"""

from __future__ import annotations

import ast
from typing import List

from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make
from spark_rapids_tpu_torch.lint.rules.common import PACKAGE, _attr_chain

#: np.random attributes that construct SEEDED generators (allowed in
#: kernels); everything else on np.random is process-global state
_SEEDED_RANDOM_OK = {"default_rng", "Generator", "SeedSequence",
                     "BitGenerator", "PCG64", "Philox"}

#: torch's sampling functions: they draw from the process-global
#: generator unless handed an explicit one (``generator=``)
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "rand_like",
                   "randn_like", "randint_like", "bernoulli", "multinomial",
                   "normal", "poisson"}


def _check_nondeterminism(rel: str, tree: ast.AST,
                          diags: List[Diagnostic]):
    in_kernel = rel.startswith((f"{PACKAGE}/execs/", f"{PACKAGE}/ops/"))
    if not in_kernel:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        parts = chain.split(".")
        bad = None
        if chain in ("time.time", "datetime.now", "datetime.datetime.now",
                     "date.today", "datetime.date.today",
                     "datetime.utcnow", "datetime.datetime.utcnow"):
            bad = f"{chain}() (wall clock)"
        elif len(parts) >= 2 and parts[-2] == "random" and \
                parts[0] in ("np", "numpy") and \
                parts[-1] not in _SEEDED_RANDOM_OK:
            bad = f"{chain}() (process-global RNG state)"
        elif chain.startswith("random.") and len(parts) == 2:
            bad = f"{chain}() (unseeded stdlib RNG)"
        elif chain in ("torch.manual_seed", "torch.seed",
                       "torch.cuda.manual_seed", "torch.cuda.seed"):
            bad = f"{chain}() (process-global torch generator)"
        elif len(parts) == 2 and parts[0] == "torch" and \
                parts[1] in _TORCH_SAMPLERS and \
                not any(kw.arg == "generator" for kw in node.keywords):
            bad = f"{chain}() without generator= (process-global torch " \
                  "generator)"
        if bad:
            diags.append(make(
                "RL-NONDETERMINISM", f"{rel}:{node.lineno}",
                f"{bad} in a kernel module — results must replay "
                "bit-identically (a seeded default_rng or torch.Generator "
                "only)"))


def _check_dead_lambdas(rel: str, tree: ast.AST,
                        diags: List[Diagnostic]):
    lambda_defs = {}
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Lambda):
            name = node.targets[0].id
            lambda_defs.setdefault(name, node.lineno)
        elif isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load):
            used.add(node.id)
    for name, lineno in sorted(lambda_defs.items(), key=lambda kv: kv[1]):
        if name not in used:
            diags.append(make(
                "RL-DEAD-LAMBDA", f"{rel}:{lineno}",
                f"lambda bound to {name!r} is never used — dead code"))
