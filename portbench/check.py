"""The comparison that decides ``correct``.

The program's set-up drives the step the window then times through its
first steps; ``ProgramReadings`` keeps, as device tensors, what they leave:
each step's loss, the step-1 gradient as AdamW took it (from the first
moment after one step, m1 = (1 - b1) clip g, and the step's gnorm), the
parameters' change over the steps, and on a repairing cell each step's
wire faults and repaired columns.  The reference then runs the same steps
from the same inputs, and ``compare`` reduces both to the numbers held to
a cell's limits:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the gradient's leaves (a stacked leaf counts once a
  layer), the largest gap between the program's and the reference's norm,
  over the larger of the reference's norm of that leaf and of the median
  leaf;
* ``update_gap``: the same for the parameters' change over the set-up
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by Adam's round-off alone);
* ``repair_miss`` (repairing cells): steps in which the repair counted
  other than the faults planted, left a planted residue other than it
  was, or left a column that is no codeword.
"""
from __future__ import annotations

import math
import statistics

import torch

from .inputs import draw_faults
from .reference.rrns import column_ok

__all__ = ["slice_norms", "ProgramReadings", "WireFaults", "compare",
           "judge"]

def slice_norms(named: dict, stacked: dict, scale=None) -> dict:
    """``{leaf: (norms,)}``: each leaf's L2 norm, a stacked leaf's one a
    layer (the leading axes ``stacked`` gives its top-level name, a
    family's ``STACKED``, kept), as float64 device tensors."""
    out = {}
    for name, t in named.items():
        lead = stacked.get(name.split("/", 1)[0], 0)
        dims = tuple(range(lead, t.ndim))
        n = torch.linalg.vector_norm(t, dim=dims, dtype=torch.float64)
        out[name] = (n if scale is None else n / scale).reshape(-1)
    return out


class WireFaults:
    """The ``transport_hook`` of a repairing cell: each step it adds a
    seeded offset to ``k`` seeded residues of the fresh wire, remembering
    the residues it replaced; ``collect`` (after the step) keeps the
    planted columns as the repair left them and the step's counts."""

    def __init__(self, seed: int, k: int, moduli: tuple[int, ...]):
        self.seed, self.k, self.moduli = seed, k, moduli
        self.step, self.pending, self.records = 0, None, []

    def __call__(self, buf):
        if tuple(buf.shape[:1]) != (len(self.moduli),):
            raise ValueError(f"wire of {buf.shape[0]} channels, expected "
                             f"{len(self.moduli)}")
        faults = draw_faults(self.seed, self.step, self.k, self.moduli,
                             buf.shape[1])
        orig = []
        for c, e, off in faults:
            orig.append(buf[c, e].clone())
            buf[c, e] = torch.remainder(buf[c, e] + off, self.moduli[c])
        self.pending = (buf, faults, orig)
        self.step += 1
        return buf

    def collect(self, metrics):
        buf, faults, orig = self.pending
        self.pending = None
        cols = [buf[:, e].clone() for _, e, _ in faults]
        counts = torch.stack([metrics["repaired"], metrics["unrepairable"]])
        self.records.append((faults, orig, cols, counts))

    def misses(self, codec: dict) -> list[bool]:
        """Per step: did the repair miss (host check, after the run)?"""
        out = []
        for faults, orig, cols, counts in self.records:
            rep, bad = (int(v) for v in counts.tolist())
            miss = rep != len(faults) or bad != 0
            for (c, _, _), o, col in zip(faults, orig, cols):
                col = col.tolist()
                miss |= col[c] != int(o) or not column_ok(col, codec)
            out.append(miss)
        return out


class ProgramReadings:
    """What the program's set-up steps leave, kept on the device."""

    def __init__(self, opt: dict, stacked: dict):
        self.opt, self.stacked, self.losses = opt, stacked, []
        self.grad = self.update = None

    def after_step(self, t: int, params, opt_state, metrics, flat):
        """Called after set-up step ``t`` (1-based) with the step's outputs;
        ``flat`` flattens a tree to ``{name: tensor}``."""
        self.losses.append(metrics["loss"].detach().float())
        if t == 1:
            gn = metrics["gnorm"].detach().double()
            clip = torch.clamp(self.opt["clip_norm"] / torch.clamp(gn, min=1e-9),
                               max=1.0)
            self.grad = slice_norms(flat(opt_state["m"]), self.stacked,
                                    (1.0 - self.opt["b1"]) * clip)

    def after_setup(self, params, params0):
        self.update = slice_norms({k: params[k] - params0[k]
                                   for k in params0}, self.stacked)

    def host(self) -> dict:
        return {"losses": torch.stack(self.losses).tolist(),
                "grad": {k: v.tolist() for k, v in self.grad.items()},
                "update": {k: v.tolist() for k, v in self.update.items()}}


def _gap(prog: dict, ref: dict, keep=None) -> float:
    """Largest |prog - ref| over max(ref, median ref), leaf by leaf."""
    names = [(k, i) for k in ref for i in range(len(ref[k]))
             if keep is None or keep[(k, i)]]
    med = statistics.median(ref[k][i] for k, i in names)
    return _worst(abs(prog[k][i] - ref[k][i]) / max(ref[k][i], med, 1e-30)
                  for k, i in names)


def _worst(gaps) -> float:
    """The largest gap; inf when any is not finite (a NaN compares false
    with everything, so ``max`` alone could pass it over)."""
    gaps = list(gaps)
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of a run from the host readings of both sides (each
    ``{"losses", "grad", "update"}``)."""
    loss_gap = _worst(abs(p - r) / abs(r)
                      for p, r in zip(prog["losses"], ref["losses"]))
    g = ref["grad"]
    med = statistics.median(v for k in g for v in g[k])
    keep = {(k, i): g[k][i] >= 1e-3 * med for k in g for i in range(len(g[k]))}
    return {"loss_gap": loss_gap,
            "grad_gap": _gap(prog["grad"], g),
            "update_gap": _gap(prog["update"], ref["update"], keep)}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit at or under it (a NaN fails).  A
    number a cell's limits leave out is reported, not compared: it has no
    reading from the control or a fault that a limit could sit below."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())
