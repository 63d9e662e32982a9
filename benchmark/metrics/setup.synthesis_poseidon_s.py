"""setup.synthesis_poseidon_s: seconds of set-up in the in-circuit
Poseidon, the "synthesis.poseidon" spans of the process's
`synthesize_circuit` calls, summed: what of `setup.synthesis_s` the hashes
take, and the rest is everything else the circuit emits.  None where no
call recorded that span: a program whose gadget is not timed."""

from harness.calls import calls

SPAN = "synthesis.poseidon"


def read(layer):
    got = [c["spans"][SPAN] for c in calls("synthesize_circuit") or ()
           if SPAN in c["spans"]]
    return sum(got) if got else None
