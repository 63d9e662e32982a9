#!/usr/bin/env python3
"""The controls of the benchmark's `correct`: runs that break one guarantee
the configuration states, which the comparison with the plain reference
has to catch.  They are not part of the benchmark's runs.

    python3 benchmark/control.py --workload mainnet.withdraw.full \
        --seed 7 --seed 8 --seed 9

For each seed, in one process: the cell's set-up, then the program's
reading (its proofs, judged) and the control's:

  * driver "prove": one proof of an assignment that breaks one constraint
    (an aux value of the witness plus one), judged against the reference's
    proof of the true assignment; its wrong points are the control's
    reading of `wrong_points`;
  * driver "chain": two blocks, then the last block's update work proven
    from a broken assignment the same way (`wrong_points`), and the
    chain's balances judged against the reference's arithmetic of a block
    whose first deposit was one more than sent (`wrong_balances`).

Prints one JSON line per seed: {"seed", "program": {...}, "control":
{...}}, each the numbers that decide `correct`.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import torch  # noqa: E402

from bazuka_tpu_torch.groth16.prove import create_proof  # noqa: E402
from harness import spec  # noqa: E402
from harness.drivers import chain, prove  # noqa: E402
from harness.outcome import Run  # noqa: E402
from reference import chain as ref_chain  # noqa: E402
from reference import groth16 as ref  # noqa: E402


class Broken:
    """A constraint system whose assignment has one aux value plus one."""

    def __init__(self, cs, index: int):
        self.cs, self.index = cs, index
        self.n_constraints = cs.n_constraints

    def compiled(self):
        return self.cs.compiled()

    def full_assignment(self):
        z = self.cs.full_assignment()
        z[self.index] = (z[self.index] + 1) % ref.R
        return z


def broken_index(cs) -> int:
    """The aux variable of the last term of the A matrix that has one: it
    takes part in a constraint, which the plus one breaks."""
    comp = cs.compiled()
    aux = comp.vars[0][comp.vars[0] >= comp.num_inputs]
    return int(aux[-1])


def prove_control(run) -> dict:
    p = prove.Prover(run)
    p.prove()
    p.prove()
    r, s = 3, 5
    bad = create_proof(p.params, Broken(p.cs, broken_index(p.cs)), r, s,
                       device=p.dev)
    del p.params
    [(wrong, _), (c_wrong, _)] = prove.judge(
        p.cs, prove.key_seed(run.seed), p.proofs, [(r, s, bad)])
    return {"program": {"wrong_points": wrong},
            "control": {"wrong_points": c_wrong}}


def chain_control(run) -> dict:
    v = chain.Validator(run)
    v.block()
    v.block()
    checks, _ = chain.judge(v, run.seed)
    kind, cs, _, _, _ = v.proofs[-1]
    params = v.keys[kind]["params"]
    r, s = 3, 5
    bad = v.prove(params, Broken(cs, broken_index(cs)), r, s)
    waste = ref.toxic(chain.key_seed(run.seed) + kind.encode())
    circuit = prove.ref_circuit(cs)
    q = ref.qap_at(circuit, cs.full_assignment(),
                   ref.lagrange_rows(circuit, waste[0]))
    c_wrong = ref.wrong_points(prove.points(bad),
                               ref.expected_proof(q, waste, r, s))
    sent = json.loads(json.dumps(v.dc.sent))
    sent[0]["deposit"][0] += 1
    want = ref_chain.expected_states(
        len(v.dc.users), v.dc.traffic["l1_funds"], v.dc.treasury,
        v.dc.conf.reward_ratio, sent)
    c_bal = sum(ref_chain.mismatches(st, w) for st, w in zip(v.states, want))
    return {"program": {k: val for k, (val, _) in checks.items()},
            "control": {"wrong_points": c_wrong, "wrong_balances": c_bal}}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("the controls run on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        run = Run(cell, seed, 0.0, False, torch.device("cuda"))
        fn = {"prove": prove_control,
              "chain": chain_control}[cell.traffic["driver"]]
        print(json.dumps({"seed": seed, **fn(run)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
