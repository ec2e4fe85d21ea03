"""The port's LM serving (``repro_torch.serve``, ``launch/serve.py``)
against the reference's, on the CPU.

``BatchedServer`` serves a wave of same-length requests through 4 lockstep
slots (6 requests, so slots are reused), in float32 in both packages from
the same parameters: the emitted tokens must be the reference's (an audio
model's: each token's 4 codes).  Every emitted token's top-2 logit margin
is held above the float32 tolerance, so a differing token is a fault, not
a tie; a MoE model's routing is compared first at every MoE call
(``test_torch_lm_model.MoERecorder``).  The reference's server cannot
splice a hybrid model's cache (it writes the mamba leaves' layer axis), so
zamba2's served tokens are held against the reference's unbatched prefill
+ decode of each request instead.  The int8 KV cache (``kv_quant``) serves
the reference's tokens too, and ``auto_kv_quant`` makes the reference's
decisions at the reference's 16 GiB.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as rmodel
from repro.serve import driver as rdriver
from repro.serve import engine as rengine

from repro_torch import configs
from repro_torch.convert import lm_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model
from repro_torch.serve import driver, engine
from test_torch_lm import F32_TOL, numpy_params
from test_torch_lm_model import MoERecorder

PLEN, NEW, SLOTS, REQUESTS = 12, 5, 4, 6


def prompts(cfg):
    rng = np.random.RandomState(11)
    shape = (PLEN, cfg.n_codebooks) if cfg.n_codebooks else (PLEN,)
    return [rng.randint(0, cfg.vocab, shape).astype(np.int32)
            for _ in range(REQUESTS)]


def served(server, reqs):
    """Run ``server`` on ``reqs``, recording every logits row it samples
    from: {rid: [logits of each emitted token]}."""
    rows = {r.rid: [] for r in reqs}
    decode = server.decode

    def recording(params, cache, toks, pos):
        logits, cache = decode(params, cache, toks, pos)
        for i, req in enumerate(server.slots):
            if req is not None:
                rows[req.rid].append(logits[i].float().numpy().copy())
        return logits, cache
    server.decode = recording
    server.run(reqs)
    return rows


def reference_tokens(cfg, params, prompts, n_new, max_seq,
                     kv_quant=False):
    """The reference's unbatched greedy continuation of each prompt."""
    prefill = jax.jit(rengine.make_prefill_step(cfg, block_q=8, block_k=8,
                                                kv_quant=kv_quant))
    decode = jax.jit(rengine.make_decode_step(cfg, kv_quant=kv_quant))
    outs = []
    for prompt in prompts:
        logits, cache = prefill(params,
                                {"tokens": jnp.asarray(prompt)[None]})
        cache = rmodel.pad_cache(cfg, cache, max_seq)
        tok = rengine.greedy_sample(logits).reshape(1, 1)
        out, pos = [], prompt.shape[0]
        for _ in range(n_new):
            logits, cache = decode(params, cache, tok, jnp.int32(pos))
            tok = rengine.greedy_sample(logits).reshape(1, 1)
            out.append(int(tok[0, 0]))
            pos += 1
        outs.append(out)
    return outs


def serve_both(arch, monkeypatch, kv_quant=False):
    """The port's and the reference's tokens for the wave of requests,
    f32, the port's sampled logits rows, and the MoE routing compared
    first (a MoE model's)."""
    cfg = rconfigs.smoke(arch)
    rp = numpy_params(cfg, 2, "f32")
    max_seq = PLEN + NEW + 2
    rec = MoERecorder(monkeypatch, cfg) if cfg.moe else None
    if rec is not None:
        rec.patch_reference(monkeypatch)
    mine = [driver.Request(rid=i, prompt=p, max_new=NEW)
            for i, p in enumerate(prompts(cfg))]
    server = driver.BatchedServer(configs.smoke(arch), lm_params(rp), SLOTS,
                                  max_seq, block=8, kv_quant=kv_quant)
    rows = served(server, mine)
    if cfg.family == "hybrid":
        want = reference_tokens(cfg, rp, prompts(cfg), NEW, max_seq,
                                kv_quant)
    else:
        ref = [rdriver.Request(rid=i, prompt=p, max_new=NEW)
               for i, p in enumerate(prompts(cfg))]
        rdriver.BatchedServer(cfg, rp, SLOTS, max_seq, block=8,
                              kv_quant=kv_quant).run(ref)
        want = [r.out for r in ref]
    if rec is not None:
        jax.effects_barrier()
        rec.ties("f32", arch)
    return mine, want, rows


def assert_served(mine, want, rows):
    for req, toks in zip(mine, want):
        assert req.done and len(req.out) == NEW
        assert req.out == toks, (req.rid, req.out, toks)
        for row in rows[req.rid]:
            top2 = np.sort(row, axis=-1)[..., -2:]    # audio: per codebook
            assert (top2[..., 1] - top2[..., 0]
                    > F32_TOL * np.abs(row).max()).all()


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-27b", "mamba2-130m",
                                  "zamba2-2.7b", "mixtral-8x22b",
                                  "llama4-scout-17b-a16e", "internvl2-76b",
                                  "musicgen-large"])
def test_batched_server_emits_the_reference_s_tokens(arch, monkeypatch):
    mine, want, rows = serve_both(arch, monkeypatch)
    if configs.smoke(arch).n_codebooks:
        assert all(len(tok) == 4 for r in mine for tok in r.out)
    assert_served(mine, want, rows)


def test_server_splices_each_leaf_at_its_batch_axis():
    """A request's prefill cache lands in its slot only, for every leaf
    (the hybrid's mamba leaves carry their batch on axis 2)."""
    cfg = configs.smoke("zamba2-2.7b")
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    server = driver.BatchedServer(cfg, params, 3, PLEN + 4, block=8)
    req = driver.Request(rid=0, prompt=prompts(cfg)[0], max_new=2)
    assert server.admit(req) and server.slots[0] is req
    step = engine.make_prefill_step(cfg, block_q=8, block_k=8)
    _, one = step(params, torch.from_numpy(req.prompt)[None])
    one = model.pad_cache(cfg, one, PLEN + 4)
    for site, leaves in server.cache.items():
        axis = model.batch_axis(cfg, site)
        for name, pool in leaves.items():
            assert pool.shape[axis] == 3
            assert torch.equal(pool.narrow(axis, 0, 1),
                               one[site][name].to(pool.dtype)), (site, name)
            assert not pool.narrow(axis, 1, 2).any(), (site, name)


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-2.7b"])
def test_kv_quant_server_emits_the_reference_s_tokens(arch, monkeypatch):
    """The int8 KV cache, pooled: int8 k / v and float32 scales at every
    KV site (zamba2's shared sites too), then the reference's tokens."""
    mine, want, rows = serve_both(arch, monkeypatch, kv_quant=True)
    assert_served(mine, want, rows)
    cfg = configs.smoke(arch)
    cache = model.cache_init(cfg, 2, 8, quant=True)
    for site, leaves in cache.items():
        if site == "mamba":
            continue
        assert set(leaves) == {"k", "v", "ks", "vs"}
        assert leaves["k"].dtype == torch.int8
        assert leaves["ks"].dtype == torch.float32
        assert leaves["ks"].shape[-1] == 1


def test_auto_kv_quant_decides_as_the_reference():
    """Every configuration, full size, at a few batch / length / device
    counts: the reference's decision at its 16 GiB."""
    decided = set()
    for arch in rconfigs.ARCH_IDS:
        for batch, seq, n_dev in ((1, 4096, 1), (32, 32768, 16),
                                  (128, 32768, 256), (1, 524288, 256),
                                  (8, 32768, 1)):
            want = rengine.auto_kv_quant(rconfigs.get(arch), batch, seq,
                                         n_dev)
            got = engine.auto_kv_quant(configs.get(arch), batch, seq, n_dev,
                                       16 * 2 ** 30)
            assert got == want, (arch, batch, seq, n_dev)
            decided.add(got)
    assert decided == {True, False}


def test_greedy_sample_takes_the_first_largest():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 0.0, 5.0]])
    assert engine.greedy_sample(logits).tolist() == [1, 0]
    assert engine.greedy_sample(logits).dtype == torch.int32


def test_launcher_serves_zamba2_smoke_on_the_cpu(capsys):
    launch_serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2x16: ")
    assert out[1].startswith("decoded 4 tokens x 2 seqs in ")
    sample = ast.literal_eval(out[2].split(":", 1)[1].strip())
    assert len(sample) == 4 and all(0 <= x < 256 for x in sample)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "internvl2-76b", "musicgen-large",
                                  "zamba2-2.7b"])
def test_launcher_serves_every_family_on_the_cpu(arch, kv_quant, capsys):
    cfg = configs.smoke(arch)
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "16", "--gen", "4"]
                      + (["--kv-quant"] if kv_quant else []))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill 2x16: ")
    assert out[1].startswith("decoded 4 tokens x 2 seqs in ")
    sample = ast.literal_eval(out[2].split(":", 1)[1].strip())
    assert len(sample) == 4 * max(cfg.n_codebooks, 1)
    assert all(0 <= x < cfg.vocab for x in sample)


@pytest.mark.parametrize("argv,message", [
    (["--arch", "no-such-model", "--device", "cpu"], "unknown --arch"),
])
def test_launcher_refuses(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_launcher_needs_a_card_for_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    with pytest.raises(SystemExit) as exc:
        launch_serve.main(["--arch", "zamba2-2.7b", "--smoke"])
    assert exc.value.code != 0
    assert "CUDA is not available" in capsys.readouterr().err
