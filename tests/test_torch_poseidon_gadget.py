"""The port's in-circuit Poseidon (`bazuka_tpu_torch/groth16/gadgets.py`
`poseidon`, emitted from a template of its width) against the JAX
package's term-by-term gadget (`bazuka_tpu/groth16/gadgets.py`), on the
CPU, with exact equality.

- At every arity 1..16 and in both modes, one constraint system hashes
  three times at that arity and once at another, interleaved, each hash
  taking the one before as an input: so a width's palette ids are reused
  by a later hash and another width's template runs between.  Their
  inputs are of every kind: fresh variables, multi-term LCs, an LC with a
  ONE term, constants and zero.  The compiled arrays, palette, counts and
  assignment equal the JAX package's, each output's LC equals its LC term
  for term in order, and in proving mode each output's value is
  `zk/poseidon_host.py`'s hash and the system is satisfied.
- Every hash is the span "synthesis.poseidon" and counts once under
  "synthesis.poseidon_hashes" in the root call around it.
- Arities 0 and 17 are refused, as the JAX package refuses them.
"""

import random

import numpy as np
import pytest
import torch

from bazuka_tpu.groth16 import gadgets as jg
from bazuka_tpu.groth16 import r1cs as jr
from bazuka_tpu_torch.groth16 import gadgets as tg
from bazuka_tpu_torch.groth16 import r1cs as tr
from bazuka_tpu_torch.utils import spans
from bazuka_tpu_torch.zk.poseidon_host import poseidon_python

# Host Python only: one intra-op thread per test process keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _inputs(g, cs, arity: int, rng: random.Random, prev):
    """`arity` Nums of every kind, cycling through them; the previous
    hash's output (a multi-term LC over its own variables) first."""
    out = [] if prev is None else [prev]
    while len(out) < arity:
        kind = len(out) % 5
        v = rng.randrange(tr.P)
        if kind == 0:
            out.append(g.Num.alloc(cs, v))
        elif kind == 1:
            out.append(g.Num.alloc(cs, v)
                       + g.Num.alloc(cs, rng.randrange(tr.P)).scale(3))
        elif kind == 2:
            out.append(g.Num.alloc(cs, v).add_const(rng.randrange(tr.P)))
        elif kind == 3:
            out.append(g.Num.constant(v))
        else:
            out.append(g.Num.zero())
    return out


def _hashes(g, r, proving: bool, arity: int):
    """The constraint system and [(output, input values)] of four hashes:
    three at `arity`, one at another width in between."""
    rng = random.Random(arity)
    cs = r.ConstraintSystem(proving=proving)
    other = arity % 16 + 1
    outs, prev = [], None
    for a in (arity, other, arity, arity):
        vals = _inputs(g, cs, a, rng, prev)
        prev = g.poseidon(cs, vals)
        outs.append((prev, [v.value for v in vals]))
    return cs, outs


def _assert_same_r1cs(cs, jcs):
    comp, jcomp = cs.compiled(), jcs.compiled()
    assert (comp.num_vars, comp.num_inputs, comp.n_constraints) == (
        jcomp.num_vars, jcomp.num_inputs, jcomp.n_constraints)
    for m in range(3):
        for field in ("rows", "vars", "cids"):
            assert np.array_equal(getattr(comp, field)[m],
                                  getattr(jcomp, field)[m]), (m, field)
    assert comp.palette == jcomp.palette
    if cs.proving:
        assert list(cs.full_assignment()) == list(jcs.full_assignment())
    else:
        assert cs.assignment == jcs.assignment


@pytest.mark.parametrize("proving", (True, False), ids=("proving", "setup"))
@pytest.mark.parametrize("arity", range(1, 17))
def test_poseidon_gadget_matches_jax(arity, proving):
    cs, outs = _hashes(tg, tr, proving, arity)
    jcs, jouts = _hashes(jg, jr, proving, arity)
    _assert_same_r1cs(cs, jcs)
    for (out, vals), (jout, _) in zip(outs, jouts):
        assert list(out.lc.items()) == list(jout.lc.items())
        assert out.value == jout.value
        if proving:
            assert out.value == poseidon_python(vals)
        else:
            assert out.value is None
    if proving:
        assert cs.is_satisfied() is None


def test_poseidon_gadget_span_and_counter():
    with spans.call("synthesize_circuit") as rec:
        cs = tr.ConstraintSystem(proving=True)
        x = tg.Num.alloc(cs, 5)
        for arity in (4, 2, 4):
            x = tg.poseidon(cs, [x] * arity)
    assert rec.counts["synthesis.poseidon_hashes"] == 3
    assert rec.counts["synthesis.poseidon"] == 3
    assert rec.spans["synthesis.poseidon"] > 0


@pytest.mark.parametrize("arity", (0, 17))
def test_poseidon_gadget_refuses_arity(arity):
    for g, r in ((tg, tr), (jg, jr)):
        cs = r.ConstraintSystem(proving=True)
        with pytest.raises(ValueError):
            g.poseidon(cs, [g.Num.constant(1)] * arity)
