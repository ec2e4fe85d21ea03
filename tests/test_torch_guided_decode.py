"""``examples/torch_guided_decode.py`` against ``examples/guided_decode.py``
on the CPU, from the reference's parameters (``M.init(CFG,
PRNGKey(0))`` and its prompt, carried across with ``convert``).

Every internal node of the depth-8 top-2 lattice (255 LM forwards a
side, bf16): the top-2 ids equal the reference's wherever the
reference's sorted log-probabilities are further apart than
``LP_TOL`` (the LM tests' bf16 tolerance) at ranks 1-2 and 2-3; a node
closer than that is a near tie and is counted, as MoE routing counts
them (the two forwards round differently), not compared.  The exact
optimum (an exhaustive walk of the lattice) has the reference's path,
and its cost (integer units of 1e-3 nats) is within ``COST_TOL`` of the
reference's; ``serial_rb`` and the simulator reach it; the example runs
and prints the reference's lines.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as rmodel
from repro.models.model import Shardings

from repro_torch.convert import lm_params
from repro_torch.core.serial import ParallelRBSimulator, serial_rb

ROOT = os.path.join(os.path.dirname(__file__), "..")
LP_TOL = 0.08
#: 8 steps at most 0.04 nats apart each.
COST_TOL = 8 * 40


def load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lattices():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ref, port = load("guided_decode"), load("torch_guided_decode")
    rparams = rmodel.init(ref.CFG, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (1, ref.PROMPT_LEN),
                                0, ref.CFG.vocab)
    ctx = rmodel.make_ctx(ref.CFG, "train", Shardings(None), block_q=16,
                          block_k=16)

    @jax.jit
    def logprobs(tokens):
        logits = rmodel.forward(ref.CFG, rparams, {"tokens": tokens}, ctx)
        return jax.nn.log_softmax(logits[0, -1].astype(jnp.float32))

    def ref_lp(prefix):
        toks = jnp.concatenate([prompt, jnp.asarray(prefix, jnp.int32)[None]],
                               axis=1) if prefix else prompt
        return np.asarray(logprobs(toks))

    expand = port.build_lattice(
        lm_params(jax.tree_util.tree_map(np.asarray, rparams)),
        torch.from_numpy(np.array(prompt, np.int32)))
    yield ref, port, ref.build_lattice(0), expand, ref_lp
    torch.set_num_threads(threads)


def optimum(expand, depth, prefix=()):
    """(cost, tokens) of the best leaf below ``prefix``, exhaustively."""
    if len(prefix) == depth:
        return 0, prefix
    ids, lps = expand(prefix)
    return min((c + int(-lps[j] * 1000), p) for j in range(2)
               for c, p in [optimum(expand, depth, prefix + (int(ids[j]),))])


def test_lattice_and_optimum(lattices):
    ref, port, ref_expand, expand, ref_lp = lattices
    compared = near = 0
    stack = [()]
    while stack:
        prefix = stack.pop()
        if len(prefix) == ref.DEPTH:
            continue
        ids, _ = ref_expand(prefix)
        got, _ = expand(prefix)
        top3 = np.sort(ref_lp(prefix))[::-1][:3]
        if min(top3[0] - top3[1], top3[1] - top3[2]) < LP_TOL:
            near += 1
        else:
            assert list(got) == list(ids), prefix
            compared += 1
        stack.extend(prefix + (int(i),) for i in ids)
    assert compared + near == 2 ** ref.DEPTH - 1
    assert compared > near
    want, got = optimum(ref_expand, ref.DEPTH), optimum(expand, port.DEPTH)
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) <= COST_TOL
    best, _, _ = serial_rb(port.make_problem(expand))
    assert best == got[0]
    sim = ParallelRBSimulator(port.make_problem(expand), c=8).run()
    assert sim.best == best
    assert port.greedy(port.make_problem(expand))[2] >= best


def test_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_guided_decode.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("greedy continuation: tokens=(")
    assert lines[1].startswith("exact optimum: -logprob=")
    assert "same optimum" in lines[2]
