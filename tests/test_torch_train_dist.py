"""The port's int8 gradient all-reduce (``train/compression.py``) and
GPipe schedule (``distributed/pipeline_parallel.py``) on a CPU mesh,
against the reference's under ``shard_map`` on 8 forced host devices.

The reference runs once, in a module-scoped subprocess (the host device
count is fixed when jax starts), on numpy inputs drawn here; the port
runs on ``Mesh(["cpu"] * 8)`` and ``Mesh(["cpu"] * 4)``.  The means are
compared bitwise (so are the int8 payloads summed); the residuals
``g - q * scale`` within 1e-5 of the shared scale (XLA fuses the product
and the difference into one rounding); the pipeline's outputs within the
reference's own tolerance (2e-5, its ``tests/test_train_substrate.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import Mesh
from repro_torch.distributed.pipeline_parallel import pipeline_forward
from repro_torch.train.compression import (compressed_psum, error_init,
                                           quantize)

SHARDS, STAGES, MICRO, MB, D = 8, 4, 6, 2, 16

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.pipeline_parallel import pipeline_forward
from repro.train.compression import compressed_psum

z = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((8,), ("data",))
out = {}
for with_error in (False, True):
    def body(a, b, ea, eb):
        err = {"a": ea, "b": eb} if with_error else None
        mean, e = compressed_psum({"a": a, "b": b}, ("data",), err)
        return mean["a"], mean["b"], e["a"], e["b"]
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 4,
                           out_specs=(P("data"),) * 4, check=False))
    res = fn(*(jnp.asarray(z[k]) for k in ("ga", "gb", "ea", "eb")))
    for name, r in zip(("mean_a", "mean_b", "err_a", "err_b"), res):
        out[f"{name}_{int(with_error)}"] = np.asarray(r)
mesh2 = jax.make_mesh((4,), ("stage",))
out["pipe"] = np.asarray(pipeline_forward(
    lambda w, x: jnp.tanh(x @ w), jnp.asarray(z["ws"]),
    jnp.asarray(z["x"]), mesh2))
np.savez(sys.argv[2], **out)
"""


def inputs():
    rng = np.random.RandomState(9)
    return {
        "ga": rng.standard_normal((SHARDS, 64)).astype(np.float32),
        "gb": (rng.standard_normal((SHARDS * 3, 5)) * 1e-3).astype(
            np.float32),
        "ea": (rng.standard_normal((SHARDS, 64)) * 1e-2).astype(np.float32),
        "eb": (rng.standard_normal((SHARDS * 3, 5)) * 1e-5).astype(
            np.float32),
        "ws": (rng.standard_normal((STAGES, D, D)) * 0.1
               + np.eye(D)[None]).astype(np.float32),
        "x": rng.standard_normal((MICRO, MB, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_dist_ref")
    np.savez(out / "in.npz", **inputs())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT,
                           str(out / "in.npz"), str(out / "ref.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def shard_trees(arrays):
    """Each shard's {"a", "b"} tree: the rows the reference's P("data")
    gives it."""
    return [{k: torch.from_numpy(np.ascontiguousarray(
        np.split(arrays[k], SHARDS)[d])) for k in arrays}
        for d in range(SHARDS)]


@pytest.mark.parametrize("with_error", [False, True])
def test_compressed_psum_is_the_reference_s(ref, with_error):
    """Every shard's mean bitwise the reference's and its residual within
    1e-5 of the scale, with and without the last residuals fed back."""
    z = inputs()
    grads = shard_trees({"a": z["ga"], "b": z["gb"]})
    error = (shard_trees({"a": z["ea"], "b": z["eb"]}) if with_error
             else None)
    means, errors = compressed_psum(grads, Mesh(["cpu"] * SHARDS), error)
    for name in ("a", "b"):
        mean = np.concatenate([m[name].numpy() for m in means])
        err = np.concatenate([e[name].numpy() for e in errors])
        np.testing.assert_array_equal(
            mean, ref[f"mean_{name}_{int(with_error)}"])
        want = ref[f"err_{name}_{int(with_error)}"]
        scale = np.abs(np.concatenate([g[name].numpy() for g in grads])
                       + (np.concatenate([e[name].numpy() for e in error])
                          if with_error else 0)).max() / 127
        assert np.abs(err - want).max() <= 1e-5 * scale
    # Every shard holds the same mean, within a shared-scale step of the
    # true one.
    true = np.mean(np.stack(np.split(z["ga"], SHARDS)), axis=0)
    scale = np.abs(z["ga"] + (z["ea"] if with_error else 0)).max() / 127
    for m in means:
        assert np.abs(m["a"].numpy() - true).max() <= scale + np.abs(
            z["ea"]).max() * with_error


def test_compression_helpers():
    g = torch.tensor([0.5, -3.0, 2.49, 400.0])
    q = quantize(g, torch.tensor(1.0))
    assert q.dtype == torch.int8
    assert q.tolist() == [0, -3, 2, 127]
    e = error_init({"w": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert e["w"].dtype == torch.float32 and not bool(e["w"].any())
    with pytest.raises(ValueError):
        compressed_psum([{"w": g}], Mesh(["cpu"] * 2))


def test_pipeline_forward_is_the_reference_s(ref):
    """4 stages, 6 microbatches: the reference's outputs, which are the
    stages applied in sequence."""
    z = inputs()
    ws = torch.from_numpy(z["ws"])
    x = torch.from_numpy(z["x"])
    out = pipeline_forward(lambda w, h: torch.tanh(h @ w),
                           [ws[s] for s in range(STAGES)], x,
                           Mesh(["cpu"] * STAGES))
    np.testing.assert_allclose(out.numpy(), ref["pipe"], rtol=2e-5,
                               atol=2e-5)
    seq = x
    for s in range(STAGES):
        seq = torch.tanh(seq @ ws[s])
    assert torch.equal(out, seq)
