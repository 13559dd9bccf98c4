"""Roofline analysis of the port's dry-run records: the port of
``repro.roofline.analyze``.

Three terms per (arch x shape) cell, computed by
:meth:`~repro_torch.roofline.cost_model.CostModel.roofline_terms` against a
device row, the NVIDIA H100 SXM's by default (its datasheet's dense bf16
tensor-core, HBM and NVLink rates):

    compute    = FLOPs       / (chips x dense bf16 FLOP/s)
    memory     = bytes       / (chips x HBM B/s)
    collective = coll bytes  / (chips x NVLink B/s)

The records (:mod:`repro_torch.launch.dryrun`, ``artifacts/dryrun_torch``)
hold per-device counts of fake tensors (``op_stats``), so the global
quantities are per-device x chips.  These are counts scored with datasheet
rates, not times measured on a card.  The bytes are eager PyTorch's
(every aten op reads its operands and writes its outputs; nothing is
fused), so the memory term is an upper bound of what fused kernels would
move.  MODEL_FLOPS is the 6·N·D (train) / 2·N·D (inference) convention
with N the active parameters; MODEL_FLOPS / FLOPs exposes remat and
attention work.

    python -m repro_torch.roofline.analyze [--mesh single] [--dir DIR]
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from .cost_model import DEVICE_TABLE, CostModel, DeviceSpec

DEFAULT_DEVICE: DeviceSpec = DEVICE_TABLE["nvidia h100 80gb hbm3"]


def artifact_dir() -> str:
    """``REPRO_TORCH_ARTIFACT_DIR``, else ``artifacts/dryrun_torch`` under
    the working directory when it exists, else the checkout's."""
    env = os.environ.get("REPRO_TORCH_ARTIFACT_DIR", "")
    if env:
        return env
    cwd = os.path.join(os.getcwd(), "artifacts", "dryrun_torch")
    if os.path.isdir(cwd):
        return cwd
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "..", "..", "artifacts", "dryrun_torch")


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    status: str
    flops_global: float = 0.0
    bytes_global: float = 0.0
    coll_bytes_global: float = 0.0
    coll_breakdown: Optional[Dict[str, float]] = None
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    bottleneck: str = ""
    mfu_bound: float = 0.0      # model_flops / (chips·peak·t_dominant)
    reason: str = ""
    memory_bytes_per_device: int = 0

    def row(self) -> str:
        if self.status != "ok":
            return (f"| {self.arch} | {self.shape} | {self.status}: "
                    f"{self.reason[:60]} | | | | | | |")
        return ("| {a} | {s} | {tc:.2e} | {tm:.2e} | {tl:.2e} | {b} | "
                "{ur:.2f} | {mfu:.1%} | {mem:.1f} |").format(
            a=self.arch, s=self.shape, tc=self.t_compute, tm=self.t_memory,
            tl=self.t_collective, b=self.bottleneck, ur=self.useful_ratio,
            mfu=self.mfu_bound, mem=self.memory_bytes_per_device / 2**30)


def analyze_cell(rec: dict, device: Optional[DeviceSpec] = None) -> CellRoofline:
    """Roofline terms for one dry-run record (its ``op_stats``)."""
    device = DEFAULT_DEVICE if device is None else device
    cell = CellRoofline(rec["arch"], rec["shape"], rec["mesh"],
                        rec.get("chips", 256), rec["status"],
                        reason=rec.get("reason", rec.get("error", "")))
    if rec["status"] != "ok":
        return cell
    chips = cell.chips
    st = rec["op_stats"]
    coll = st["collective_bytes"]
    cell.coll_breakdown = coll
    cell.flops_global = float(st["flops"]) * chips
    cell.bytes_global = float(st["bytes"]) * chips
    cell.coll_bytes_global = float(sum(coll.values())) * chips
    terms = CostModel(device).roofline_terms(
        cell.flops_global, cell.bytes_global, cell.coll_bytes_global, chips)
    cell.t_compute = terms["t_compute"]
    cell.t_memory = terms["t_memory"]
    cell.t_collective = terms["t_collective"]
    cell.bottleneck = terms["bottleneck"]
    cell.model_flops = float(rec.get("model_flops", 0.0))
    cell.useful_ratio = (cell.model_flops / cell.flops_global
                         if cell.flops_global else 0.0)
    t_dom = terms["t_dominant"]
    peak = device.tensor_flops_bf16 or device.peak_flops
    cell.mfu_bound = (cell.model_flops / (chips * peak * t_dom)
                      if t_dom else 0.0)
    ma = rec.get("memory_analysis", {})
    cell.memory_bytes_per_device = int(
        ma.get("argument_size_in_bytes", 0) + ma.get("temp_size_in_bytes", 0)
        + ma.get("output_size_in_bytes", 0))
    return cell


def load_records(artifact_dir_: Optional[str] = None, mesh: str = "single"
                 ) -> List[dict]:
    d = artifact_dir() if artifact_dir_ is None else artifact_dir_
    recs = []
    for f in sorted(glob.glob(os.path.join(d, f"*__{mesh}.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def analyze_all(artifact_dir_: Optional[str] = None, mesh: str = "single"
                ) -> List[CellRoofline]:
    return [analyze_cell(r) for r in load_records(artifact_dir_, mesh)]


def markdown_table(cells: List[CellRoofline]) -> str:
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "bottleneck | useful FLOP ratio | MFU bound | HBM GiB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|")
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    cells = sorted(cells, key=lambda c: (c.arch, order.get(c.shape, 9)))
    return "\n".join([hdr] + [c.row() for c in cells])


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    cells = analyze_all(args.dir, args.mesh)
    print(markdown_table(cells))
    for c in cells:
        if c.status == "ok":
            print(f"\n{c.arch} {c.shape}: dominant={c.bottleneck} "
                  f"t={max(c.t_compute, c.t_memory, c.t_collective):.3e}s "
                  f"coll={c.coll_breakdown}")
    return cells


if __name__ == "__main__":
    main()
