"""Dry run of every (arch x shape) cell on one H100: will it fit, and
what bounds it (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for a 256-chip TPU mesh on
placeholder devices and reads XLA's memory and cost analyses.  Eager
PyTorch has no compile step; the port runs the cell's real step (the
training step, the prefill or a decode step) once on stand-ins on the
``meta`` device, which have shapes and dtypes and no storage, under
``roofline.analyze``: every ATen operation is counted as the card would
run it, each hand-written kernel by its cost function, and the live
storages are tracked.  Nothing is allocated and nothing needs a card.

Per cell:
  1. the cell's batch on one card: the reference's global batch shared
     over its 256 chips, rounded up to a whole sequence (1 for all four
     shapes), at the shape's sequence length;
  2. stand-ins for the arguments: f32 master parameters, AdamW's
     moments and a batch (train); bf16 parameters and tokens (prefill);
     bf16 parameters, the cache (int8 when ``serve.auto_kv_quant`` says
     so for the device's memory) and one token per sequence (decode);
  3. one traced step: memory (argument, temp, output, alias and peak
     bytes, and whether the peak fits the device) and the three roofline
     terms against the H100's data sheet (``launch.mesh``);
  4. one JSON artifact per cell under ``dryrun_out/`` at the root of the
     checkout.

The device's memory is ``torch.cuda.get_device_properties(0).
total_memory`` where a card is present, else the data sheet's 80 GB;
the JSON says which.  The reference's ``--multi-pod``,
``--both-meshes``, ``--seq-shard``, ``--no-heads-shard`` and
``--save-hlo`` have no counterpart: the port's LM runs on one device and
there is no HLO.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import configs, roofline
from repro_torch.core.api import tree_map
from repro_torch.data.pipeline import input_abstract
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, LINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, ShapeConfig, shapes_for
from repro_torch.serve.engine import (auto_kv_quant, decode_tokens_abstract,
                                      make_decode_step, make_prefill_step)
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import make_train_step, master_params

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out"

#: The reference's single-pod cell shares its global batch over this many
#: chips.
REFERENCE_CHIPS = 256

#: The reference's defaults (``dryrun.py``'s ``perf``).
DEFAULT_PERF = dict(block_q=256, block_k=256, microbatches=None,
                    kv_quant=None)


def card_shape(shape: ShapeConfig, batch: Optional[int] = None
               ) -> ShapeConfig:
    """``shape`` with the batch one card takes: ``batch``, or the
    reference's per-chip share of the global batch rounded up."""
    if batch is None:
        batch = math.ceil(shape.global_batch / REFERENCE_CHIPS)
    return ShapeConfig(shape.name, shape.seq_len, batch, shape.kind)


def device_memory() -> Tuple[int, str]:
    """(bytes, source) of the device the cells are checked against: the
    card's ``total_memory`` where one is present, else the data sheet's."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                f"{torch.cuda.get_device_name(0)} total_memory")
    return HBM_BYTES, "H100 data sheet (80 GB)"


def materialize(tree: Any, device) -> Any:
    """Zeros on ``device`` in the place of each stand-in of ``tree``:
    the arguments of the cell's measured twin (``chip_smoke.py`` phase
    29 holds the dry run's peak to the card's)."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), tree)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                perf_opts: Optional[Dict[str, Any]] = None,
                memory_bytes: int = HBM_BYTES, device="meta"
                ) -> Tuple[Callable, Tuple]:
    """(step, args) of ``shape`` (its ``global_batch`` is the card's
    batch); ``step(*args)`` is the port's train, prefill or decode step.
    The args are stand-ins on ``meta``, or for another ``device`` zeros
    there (``materialize``).  ``memory_bytes`` is the device's, for
    ``auto_kv_quant``."""
    perf = dict(DEFAULT_PERF)
    perf.update(perf_opts or {})
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        params = master_params(cfg, M.abstract(cfg))     # f32 masters
        args = (params, adamw_init(params), input_abstract(cfg, b, s))
        train = make_train_step(cfg, microbatches=perf["microbatches"],
                                block_q=perf["block_q"],
                                block_k=perf["block_k"], device=device)

        def train_step(params, opt, batch):
            return train(params, opt, batch, 1)
        return train_step, materialize(args, device)

    if shape.kind == "prefill":
        batch = input_abstract(cfg, b, s)
        prefill = make_prefill_step(cfg, block_q=perf["block_q"],
                                    block_k=perf["block_k"])

        def prefill_step(params, tokens, vision=None):
            return prefill(params, tokens, vision)
        args = (M.abstract(cfg), batch["tokens"])
        if "vision" in batch:
            args += (batch["vision"],)
        return prefill_step, materialize(args, device)

    quant = perf["kv_quant"]
    if quant is None:
        quant = auto_kv_quant(cfg, b, s, 1, memory_bytes)
    decode = make_decode_step(cfg, kv_quant=quant)

    def decode_step(params, cache, tokens):
        return decode(params, cache, tokens, s - 1)
    return decode_step, materialize(
        (M.abstract(cfg), M.cache_abstract(cfg, b, s, quant=quant),
         decode_tokens_abstract(cfg, b)), device)


def run_cell(arch: str, shape: Union[str, ShapeConfig],
             perf_opts: Optional[Dict[str, Any]] = None,
             batch: Optional[int] = None) -> Dict[str, Any]:
    """One cell traced on ``meta``: its memory and roofline as a dict.
    ``shape`` is a name of ``shapes_for`` (the card's batch from the
    reference's, or ``batch``) or a ``ShapeConfig`` taken as is (its
    ``global_batch`` the card's batch)."""
    cfg = configs.get(arch)
    if isinstance(shape, str):
        found = {s.name: s for s in shapes_for(cfg)}.get(shape)
        if found is None:
            return {"arch": arch, "shape": shape, "skipped": True,
                    "reason": "quadratic attention at 500k (DESIGN.md)"}
        shape = card_shape(found, batch)
    mem_bytes, mem_source = device_memory()
    step, args = input_specs(cfg, shape, perf_opts, mem_bytes)
    t0 = time.perf_counter()
    counts, mem, _ = roofline.analyze(step, *args)
    trace_s = time.perf_counter() - t0

    terms = counts.terms(PEAK_FLOPS_BF16, HBM_BW, LINK_BW)
    dominant = roofline.dominant(terms)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mflops = roofline.model_flops(cfg, tokens, shape.is_train)
    peak = mem.peak_bytes
    return {
        "arch": arch, "shape": shape.name, "mesh": "1", "n_devices": 1,
        "kind": shape.kind, "batch": shape.global_batch,
        "seq_len": shape.seq_len, "perf_opts": perf_opts or {},
        "trace_s": trace_s,
        "memory": {
            "argument_bytes": mem.argument_bytes,
            "temp_bytes": mem.temp_bytes,
            "output_bytes": mem.output_bytes,
            "alias_bytes": mem.alias_bytes,
            "peak_bytes": peak,
            "device_bytes": mem_bytes, "device_bytes_source": mem_source,
            "fits": peak <= mem_bytes,
        },
        "roofline": {
            "flops_per_dev": counts.flops,
            "dots": counts.dots,
            "kernel_launches": counts.kernels,
            "hbm_bytes_per_dev": counts.hbm_bytes,
            "score_bytes_per_dev": counts.score_bytes,
            "collective_bytes_per_dev": counts.collective_bytes,
            "per_collective": counts.per_collective,
            "compute_s": terms["compute_s"],
            "memory_s": terms["memory_s"],
            "memory_kernel_adj_s": terms["memory_kernel_adj_s"],
            "collective_s": terms["collective_s"],
            "dominant": dominant,
            "model_flops_total": mflops,
            "useful_flops_ratio": (mflops / counts.flops if counts.flops
                                   else 0.0),
            "roofline_fraction": (mflops / PEAK_FLOPS_BF16 / terms[dominant]
                                  if terms[dominant] > 0 else 0.0),
        },
    }


def artifact_path(arch: str, shape: str, tag: str = "") -> pathlib.Path:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return ARTIFACT_DIR / f"{arch}__{shape}{suffix}.json"


def cell_line(res: Dict[str, Any]) -> str:
    """The ``[ok]`` line of a cell."""
    r, mem = res["roofline"], res["memory"]
    return (f"[ok] {res['arch']} {res['shape']} B={res['batch']} "
            f"trace_s={res['trace_s']:.2f} peak="
            f"{mem['peak_bytes'] / 2 ** 30:.2f}GiB fits={mem['fits']} "
            f"dominant={r['dominant']} frac={r['roofline_fraction']:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--block-q", type=int, default=256)
    ap.add_argument("--block-k", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--kv-quant", type=int, default=None,
                    help="1/0 override of the auto int8-KV policy")
    ap.add_argument("--batch", type=int, default=None,
                    help="the card's batch (default: the reference's "
                         "global batch over its 256 chips, rounded up)")
    args = ap.parse_args(argv)

    perf = {"block_q": args.block_q, "block_k": args.block_k,
            "microbatches": args.microbatches,
            "kv_quant": None if args.kv_quant is None else bool(args.kv_quant)}
    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    cells = [(arch, shape.name) for arch in archs
             for shape in shapes_for(configs.get(arch))
             if not args.shape or shape.name == args.shape]

    ok = failed = 0
    for arch, shape in cells:
        path = artifact_path(arch, shape, args.tag)
        if args.skip_existing and path.exists():
            print(f"[skip] {arch} {shape}")
            ok += 1
            continue
        try:
            res = run_cell(arch, shape, perf, args.batch)
            path.write_text(json.dumps(res, indent=1))
            print(cell_line(res), flush=True)
            ok += 1
        except Exception as e:            # noqa: BLE001 — record and continue
            failed += 1
            print(f"[FAIL] {arch} {shape}: {type(e).__name__}: {e}",
                  flush=True)
    print(f"dry-run: {ok} ok, {failed} failed")
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
