"""Driver "prove": a prover's closed loop over one MPN batch.

Set-up builds the batch from the seed (`harness.mpn_batch`), synthesises
its circuit once, makes its key on the card from the seed
(`generate_parameters` on that circuit) and proves it once to warm up.
The window then calls `create_proof` back to back, each proof with a fresh
(r, s) drawn from the seed, until `--seconds` have passed; `proof_s` is the
window's seconds over its proofs.  The program keeps nothing across proofs
that depends on the witness (the row plans, dedup plans, h(x) and the MSMs
are made anew each call; only the circuit's device matrices and the NTT
tables of at most 2^21 rows are kept), so each proof does a new batch's
work.

A traced run records each window proof's stage seconds, then proves once
more under torch.profiler (the traced call), and once more with the curve
adds' active lanes counted (the kernels' bounds).  Every proof is then
judged against the plain reference (`reference.groth16`), after the
program's state is freed.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from bazuka_tpu_torch.groth16 import keygen, prove
from bazuka_tpu_torch.mpn.circuits import synthesize_circuit
from bazuka_tpu_torch.ops import _cuda
from bazuka_tpu_torch.ops import curve_kernels as ck
from reference import groth16 as ref
from reference.curve import R

from .. import counting, mpn_batch
from .. import trace as tr
from ..outcome import Outcome, log

K1 = ("mont_mul_fr", "mont_mul_fp", "ntt_stages_fr", "mont_inv_fp")
CURVE_ADDS = (ck.K_G1_MADD, ck.K_G1_ADD, ck.K_G2_MADD, ck.K_G2_ADD)


def key_seed(seed: int) -> bytes:
    return b"benchmark-key-%d" % seed


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def points(proof):
    """A Groth16Proof's (A, B, C) as affine ints, None at infinity."""
    return tuple(None if w.infinity else (w.x, w.y)
                 for w in (proof.a, proof.b, proof.c))


def stage_spans(t0: float, seconds: dict) -> list:
    """`create_proof`'s stage seconds laid end to end from t0."""
    spans, t = [], t0
    for name, s in seconds.items():
        spans.append((name, t, t + s))
        t += s
    return spans


class Prover:
    def __init__(self, run):
        cell, self.dev = run.cell, run.device
        t = time.perf_counter()
        if self.dev.type == "cuda":
            _cuda.build_all()
            t = log("build", t)
        circuit, _ = mpn_batch.build(cell.config, cell.traffic, run.seed)
        t = log("witness", t)
        self.cs = synthesize_circuit(circuit)
        del circuit
        t = log(f"synthesis ({self.cs.n_constraints} constraints)", t)
        self.params = keygen.generate_parameters(
            self.cs, seed=key_seed(run.seed), device=self.dev)
        log("key", t)
        self.rng = random.Random(run.seed)
        self.proofs = []  # (r, s, proof)

    def prove(self, record=None):
        r, s = self.rng.randrange(1, R), self.rng.randrange(1, R)
        proof = prove.create_proof(self.params, self.cs, r, s,
                                   device=self.dev, record=record)
        sync(self.dev)
        self.proofs.append((r, s, proof))
        return proof

    def active_lanes(self) -> dict:
        """One more proof, with each curve add's launch noted as (lanes,
        active lanes): {kernel name: [(lanes, active), ...]}."""
        seen = {k.name: [] for k in CURVE_ADDS}
        for k in CURVE_ADDS:
            def launch(tensors, n, extra=0, _k=k, _orig=k.launch):
                seen[_k.name].append((n, tensors[2][:n].sum()))
                return _orig(tensors, n, extra)
            k.launch = launch
        try:
            self.prove()
        finally:
            for k in CURVE_ADDS:
                del k.launch
        return {name: list(zip([n for n, _ in v], torch.stack(
            [a for _, a in v]).tolist() if v else []))
            for name, v in seen.items()}


def roofline(sizes: dict, active: dict, trace) -> float | None:
    """The K1-K5 launches' bounds over their device time, in %: None when
    the counted proof's curve adds differ from the traced one's."""
    for k in CURVE_ADDS:
        if sum(sizes[k.name].values()) != len(active[k.name]):
            return None
    bound = sum(count * counting.launch_bound_s(name, n, extra)
                for name in K1 for (n, extra), count in sizes[name].items())
    bound += sum(counting.launch_bound_s(name, n, a)
                 for name, launches in active.items() for n, a in launches)
    kernel_s = trace.kernel_s(tr.PROOF_KERNELS)
    return 100.0 * bound / kernel_s if kernel_s > 0 else None


def ref_circuit(cs) -> dict:
    """A constraint system's matrices as the reference takes them."""
    comp = cs.compiled()
    return {"n_constraints": comp.n_constraints, "n_inputs": comp.num_inputs,
            "palette": comp.palette,
            "terms": list(zip(comp.rows, comp.vars, comp.cids))}


def judge(cs, key: bytes, *groups) -> list:
    """(wrong points, wrong proofs) of each group of proofs [(r, s,
    proof)] against the reference."""
    circuit = ref_circuit(cs)
    waste = ref.toxic(key)
    q = ref.qap_at(circuit, cs.full_assignment(),
                   ref.lagrange_rows(circuit, waste[0]))
    out = []
    for proofs in groups:
        wrong = [ref.wrong_points(points(proof),
                                  ref.expected_proof(q, waste, r, s))
                 for r, s, proof in proofs]
        out.append((sum(wrong), sum(w > 0 for w in wrong)))
    return out


def run(run) -> Outcome:
    p = Prover(run)
    t = time.perf_counter()
    p.prove()  # warm-up: the circuit's device matrices, first launches
    log("warm proof", t)
    dev = p.dev
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    stages = []
    t0 = time.perf_counter()
    n = 0
    while True:
        rec = {} if run.trace else None
        p.prove(rec)
        n += 1
        if rec is not None:
            stages.append(rec["seconds"])
        if time.perf_counter() - t0 >= run.seconds:
            break
    window = time.perf_counter() - t0
    t = log(f"window ({n} proofs)", t0)
    layer = {"stages": stages,
             "window_peak_bytes": torch.cuda.max_memory_allocated()
             if cuda else 0}
    trace, spans = None, []
    if run.trace and cuda:
        rec, t_call = {}, []
        _cuda.reset_counts()

        def traced():
            t_call.append(time.perf_counter())
            return p.prove(rec)
        _, trace = tr.profiled(traced)
        sizes = _cuda.sizes()
        spans = stage_spans(t_call[0], rec["seconds"])
        layer["roofline_pct"] = roofline(sizes, p.active_lanes(), trace)
        layer["idle_pct"] = 100.0 * (1 - trace.busy_s() / trace.window_s)
        t = log("traced and counted proofs", t)
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    cs, proofs = p.cs, p.proofs
    del p
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    [(wrong, bad)] = judge(cs, key_seed(run.seed), proofs)
    log(f"reference ({len(proofs)} proofs)", t)
    return Outcome(window_start=t0, end_to_end={"proof_s": window / n},
                   attempted=len(proofs), failed=bad,
                   checks={"wrong_points": (wrong, 0)},
                   memory_peak_bytes=peak, layer=layer, trace=trace,
                   spans=spans)
