"""The share of the excited states' chunk boundaries whose chunk ran with
the delayed-GS gate engaged (no stored-state streams, the lower states
projected out at the boundary), in %: the ``wafer.admixture`` spans over
the ``wafer.measure`` spans, both inside the harness's
``portbench.state.<k>`` spans with k ≥ 1, in the traced stretch. The port
opens ``wafer.admixture`` inside a boundary's ``wafer.measure`` exactly
when the chunk before it ran delayed. Nothing without a trace, without an
excited state's measure, or from a program that does not trace its gate
(one whose ``SolveResult`` has no ``gate``)."""

import dataclasses

from portbench.trace import STATE_SPAN


def _traces_the_gate() -> bool:
    from wafer_torch import solver

    return any(f.name == "gate" for f in dataclasses.fields(solver.SolveResult))


def read(record):
    if record.trace is None:
        return None
    excited = [(start, start + dur) for name, start, dur in record.trace.spans
               if name.startswith(STATE_SPAN) and int(name[len(STATE_SPAN):]) >= 1]
    counts = {"wafer.measure": 0, "wafer.admixture": 0}
    for name, start, _dur in record.trace.spans:
        if name in counts and any(a <= start <= b for a, b in excited):
            counts[name] += 1
    if not counts["wafer.measure"] or not _traces_the_gate():
        return None
    return 100.0 * counts["wafer.admixture"] / counts["wafer.measure"]
