"""The port's dry run (``repro_torch.roofline``, ``launch.dryrun`` and
the abstract stand-ins) against the reference's, on the CPU.

* The stand-ins (parameters, bf16 and int8 caches, training inputs,
  decode tokens) of all ten configurations and every shape of
  ``shapes_for`` equal the reference's ``ShapeDtypeStruct`` s leaf by
  leaf in shape and dtype (the parameters restacked over the groups as
  ``convert.lm_tree`` stacks them), and lie on ``meta``.
* ``param_count``, ``active_param_count`` and ``model_flops`` equal the
  reference's.
* The counter against the reference's HLO parser on the same work, L
  bf16 matrix products with a tanh epilogue: the reference scans them
  under ``jax.jit`` and parses the compiled HLO with ``analyze_hlo``,
  the port runs them in a Python loop under ``analyze``.  The product
  FLOPs are equal.  The bytes are not: the reference models a TPU
  compiler that fuses the tanh into the product (it skips elementwise
  ops) and charges the scan's carried buffers, the port counts each ATen
  operation as an eager kernel (each input read once, each output
  written once), so its bytes equal the hand count of that rule.
* The live-storage tracker: a function with known allocations and frees
  gives the hand-counted peak on ``meta`` and on real CPU tensors; a
  view counts once, an argument written in place and returned counts as
  alias.
* The CLI on one cell (the counterpart of ``test_dryrun_cell_miniature``)
  and a small training cell: its arguments exactly the parameters times
  12 bytes plus the batch, its backward's recompute bytes above 0.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import roofline as rroofline
from repro.data import pipeline as rpipeline
from repro.models import model as rmodel
from repro.serve import engine as rengine

from repro_torch import configs, roofline
from repro_torch.convert import _restack, lm_paths
from repro_torch.core.api import tree_leaves
from repro_torch.data.pipeline import input_abstract
from repro_torch.launch import dryrun
from repro_torch.models import model
from repro_torch.models.config import ShapeConfig, shapes_for
from repro_torch.serve.engine import decode_tokens_abstract

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = sorted(configs.ALIASES)


def shape_dtype(t: torch.Tensor):
    """(shape, dtype name) of a stand-in, checked to lie on ``meta``."""
    assert t.device.type == "meta"
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def ref_shape_dtype(sds):
    return tuple(sds.shape), np.dtype(sds.dtype).name


def ref_leaves(tree):
    """{key path: (shape, dtype)} of a reference tree of
    ``ShapeDtypeStruct`` s."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): ref_shape_dtype(leaf)
            for path, leaf in flat}


def port_leaves(tree):
    """{key path: (shape, dtype)} of the port's dict tree of stand-ins,
    its lists of groups stacked as the reference stacks them."""
    stacked = _restack(tree_map_sd(tree), lambda items: (
        (len(items),) + items[0][0], items[0][1]))
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = t
    walk(stacked, ())
    return out


def tree_map_sd(tree):
    if isinstance(tree, dict):
        return {k: tree_map_sd(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_sd(v) for v in tree]
    return shape_dtype(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    port = model.abstract(cfg)
    got = port_leaves(port)
    want = ref_leaves(rmodel.abstract(rcfg))
    assert got == want
    assert sorted(got) == sorted(lm_paths(port))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_caches_inputs_tokens_equal_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for shape in shapes_for(cfg):
        b, s = shape.global_batch, shape.seq_len
        for quant in (False, True):
            got = port_leaves(model.cache_abstract(cfg, b, s, quant=quant))
            want = ref_leaves(rmodel.cache_abstract(rcfg, b, s,
                                                    quant=quant))
            assert got == want, (shape.name, quant)
        got = {k: shape_dtype(v)
               for k, v in input_abstract(cfg, b, s).items()}
        want = {k: ref_shape_dtype(v)
                for k, v in rpipeline.input_abstract(rcfg, b, s).items()}
        assert got == want, shape.name
        assert shape_dtype(decode_tokens_abstract(cfg, b)) == \
            ref_shape_dtype(rengine.decode_tokens_abstract(rcfg, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    for tokens, is_train in ((4096, True), (32768, False), (1, False)):
        assert roofline.model_flops(cfg, tokens, is_train) == \
            rroofline.model_flops(rcfg, tokens, is_train)


#: L bf16 products [M, K] @ [K, N], each followed by a tanh.
L, M, K, N = 4, 64, 128, 128


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_counter_against_analyze_hlo(device):
    def ref_f(h, ws):
        def body(h, w):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, h, ws)[0]
    hlo = jax.jit(ref_f).lower(jnp.zeros((M, K), jnp.bfloat16),
                               jnp.zeros((L, K, N), jnp.bfloat16)
                               ).compile().as_text()
    want = rroofline.analyze_hlo(hlo)

    def f(h, ws):
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h
    counts, _, out = roofline.analyze(
        f, torch.zeros((M, K), dtype=torch.bfloat16, device=device),
        torch.zeros((L, K, N), dtype=torch.bfloat16, device=device))
    assert out.shape == (M, N) and out.device.type == device
    assert counts.flops == want.flops == L * 2 * M * K * N
    assert counts.dots == L
    # Each layer: the product reads h and w and writes its output, the
    # tanh reads and writes [M, N]; the select of ws[i] is a view.
    per_layer = 2 * (M * K + K * N + M * N) + 2 * 2 * M * N
    assert counts.hbm_bytes == L * per_layer
    assert counts.hbm_bytes != want.hbm_bytes       # the fusion model's
    assert counts.score_bytes == 0 and counts.collective_bytes == 0


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_memory_tracker_known_peak(device):
    def f(x, y):
        a = x * 2                         # +4096
        b = a + 1                         # +4096: a and b live
        del a                             # -4096
        c = b.view(32, 32)                # a view: nothing new
        y.add_(1)                         # written in place
        d = torch.cat([c.flatten(), c.flatten()])   # +8192: b and d live
        return d, y

    x = torch.ones(1024, device=device)
    y = torch.ones(512, device=device)
    counts, mem, (d, y_out) = roofline.analyze(f, x, y)
    assert y_out is y and d.shape == (2048,)
    assert mem.argument_bytes == 4096 + 2048
    assert mem.output_bytes == 8192 + 2048
    assert mem.alias_bytes == 2048
    assert mem.peak_bytes == 4096 + 2048 + 4096 + 8192
    assert mem.temp_bytes == 4096
    # x * 2, a + 1: read and write 4 KB each; add_ writes y once; cat
    # reads 2 x 4 KB (views of b) and writes 8 KB.
    assert counts.hbm_bytes == 2 * 8192 + 2048 + 16384


def test_cli_one_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch mamba2-130m --shape
    decode_32k`` on a CPU-only torch: ``[ok]``, ``dry-run: 1 ok`` and the
    artifact's keys."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--tag", "test_cli"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[ok] mamba2-130m decode_32k" in out.stdout
    assert "trace_s=" in out.stdout
    assert "dry-run: 1 ok, 0 failed" in out.stdout
    path = dryrun.artifact_path("mamba2-130m", "decode_32k", "test_cli")
    res = json.loads(path.read_text())
    path.unlink()
    assert res["n_devices"] == 1 and res["batch"] == 1
    assert res["seq_len"] == 32768 and res["kind"] == "decode"
    assert set(res["memory"]) == {
        "argument_bytes", "temp_bytes", "output_bytes", "alias_bytes",
        "peak_bytes", "device_bytes", "device_bytes_source", "fits"}
    assert res["memory"]["fits"] is True
    assert res["memory"]["peak_bytes"] == (
        res["memory"]["argument_bytes"] + res["memory"]["temp_bytes"]
        + res["memory"]["output_bytes"] - res["memory"]["alias_bytes"])
    # decode writes the cache in place and returns it
    assert res["memory"]["alias_bytes"] > 0
    for key in ("flops_per_dev", "hbm_bytes_per_dev", "score_bytes_per_dev",
                "collective_bytes_per_dev", "compute_s", "memory_s",
                "collective_s", "dominant", "model_flops_total",
                "useful_flops_ratio", "roofline_fraction"):
        assert key in res["roofline"], key
    assert res["roofline"]["dominant"] == "memory_s"
    assert res["roofline"]["model_flops_total"] == roofline.model_flops(
        configs.get("mamba2-130m"), 1, False)


def test_card_shape_is_the_reference_share():
    for arch in ARCHS:
        for shape in shapes_for(configs.get(arch)):
            assert dryrun.card_shape(shape).global_batch == 1
            assert dryrun.card_shape(shape).seq_len == shape.seq_len


def test_small_training_cell():
    """zamba2's smoke configuration (2 groups of 2 mamba layers and the
    shared attention block), one AdamW step of 2 x 64 on ``meta``."""
    cfg = configs.smoke("zamba2-2.7b")
    shape = ShapeConfig("train", 64, 2, "train")
    step, args = dryrun.input_specs(cfg, shape, dict(block_q=16, block_k=16))
    assert all(t.device.type == "meta" for t in tree_leaves(args))
    counts, mem, out = roofline.analyze(step, *args)
    n_params = sum(t.numel() for t in tree_leaves(model.abstract(cfg)))
    assert mem.argument_bytes == 12 * n_params + 2 * (2 * 64 * 4)
    # params and moments written in place and returned
    assert mem.alias_bytes == 12 * n_params
    assert counts.score_bytes > 0                # the plain recomputes
    assert counts.kernels == {"flash_attention": 2, "ssd_scan": 4}
    assert counts.flops > roofline.model_flops(cfg, 2 * 64, True) / 2
    params, opt, metrics = out
    assert metrics["loss"].shape == () and metrics["loss"].device.type == \
        "meta"
