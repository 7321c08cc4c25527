"""Data and tensor parallelism of the port (`mtasr_tpu_torch/parallel/`)
against the JAX package's mesh, on the CPU.

The port's ranks are processes on gloo (`tests/_torch_parallel_worker.py`,
which imports no JAX), each pinned to one thread; the JAX reference runs
here on the conftest's virtual devices, `make_mesh(dp, tp,
devices=jax.devices()[:dp * tp])`, with the same weights (`tree_to_flat`)
and the same numpy-seeded inputs. The tiny geometry has 4 encoder heads
and 4 q / 2 kv decoder heads, so at tp = 2 both attentions, the MLPs and
the vocab-parallel embedding / head (vocab 64) are sharded, while the CTC
heads (65 rows) fall back to replication.

* the rule table against `spec_for_path` on every parameter of the bf16,
  int8, hybrid and family models, with the documented deviations;
* the four region operators and the collectives against one process's
  autograd; the multihost flow of `_multihost_worker.py` on two ranks and
  `initialize`'s error contract;
* serving at dp2 x tp2: greedy tokens and the prefill's and first decode
  steps' logits, the int8 route (w8a8 + int8 KV), beam W = 2, CTC-drafted
  speculative decoding, `generate_ctc`, and a ctcaware adapter model;
* training at dp = 2 against one process (SpecAugment masks on); the
  dp2 x tp2 steps against JAX and the sharded save -> resume are in
  `test_torch_parallel_train.py`.

Tolerances are those of the single-process A/Bs of the same modules
(`test_torch_slice.py`, `test_torch_train.py`, `test_torch_hybrid.py`):
the ranks sum row-parallel products in another order than one GEMM.
JAX is imported inside the tests only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mtasr_tpu_torch import config as tconfig
from mtasr_tpu_torch.parallel import mesh as tmesh, multihost
from tests._torch_parallel_worker import Ranks

# one intra-op thread: the suite's workers share the cores
torch.set_num_threads(1)

# float32 on the CPU, the same sums in another order
LOGITS_ATOL = 1e-5        # test_torch_family_slice.py's
LOSS_RTOL = 1e-5          # test_torch_train.py's
GNORM_RTOL = 1e-4
PARAM_ATOL = 1e-5         # 1 % of lr 1e-3 (test_torch_train.py)
SCORE_ATOL = 1e-4         # beam scores: sums of 6 log-probs

MESH = (2, 2)


def _port(cfg):
    return tconfig.from_fields(tconfig.SpeechEncoderDecoderConfig, cfg)


def _tiny(**kw):
    from tests.test_composite import tiny_cfg
    cfg = tiny_cfg(**{"lora_dropout": 0.0, "separator_dropout": 0.0, **kw})
    cfg.encoder = dataclasses.replace(cfg.encoder, num_attention_heads=4)
    return cfg


def _hybrid(**kw):
    cfg = _tiny(train_mode="hybrid", talker_ctc=True, **kw)
    cfg.encoder.mask_time_prob = 0.05    # gives the model masked_spec_embed
    return cfg


def _attention():
    cfg = _tiny(train_mode="attention")
    cfg.encoder.mask_time_prob = 0.05
    return cfg


def _flat(params):
    from mtasr_tpu.utils.torch_interop import tree_to_flat
    return {k: np.asarray(v) for k, v in tree_to_flat(params).items()}


def _params(cfg, seed=0, lora=False, decoder_scale=1.0):
    import jax
    import jax.numpy as jnp

    from mtasr_tpu.models.speech_encoder_decoder import init_model_params
    from mtasr_tpu.train.lora import init_decoder_lora
    params = init_model_params(jax.random.key(seed), cfg)
    if decoder_scale != 1.0:   # the init's 0.02 repeats one token
        params["decoder"] = jax.tree_util.tree_map(
            lambda x: x * decoder_scale if x.ndim == 2 else x,
            params["decoder"])
    if lora:
        params["decoder_lora"] = init_decoder_lora(
            jax.random.key(seed + 1), params["decoder"], r=4, alpha=8.0)
        rng = np.random.default_rng(seed + 2)
        for li, projs in params["decoder_lora"].items():
            if li != "__meta__":
                for ab in projs.values():   # a nonzero B: A gets gradients
                    ab["lora_B"] = jnp.asarray(rng.standard_normal(
                        ab["lora_B"].shape).astype(np.float32) * 0.05)
    return params


def _wav(B=4, S=8000, seed=0, pad=True):
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((B, S)).astype(np.float32)
    amask = np.ones((B, S), np.int32)
    if pad:
        amask[-1, 5000:] = 0
    return wav, amask


def _train_batch(cfg, B=4, seed=2, S=3200):
    from mtasr_tpu_torch.data.specaugment import compute_mask_indices
    from tests.test_composite import make_batch
    wav, amask, arr = make_batch(cfg, B=B, S=S, seed=seed)
    T0 = cfg.encoder.conv_output_length(wav.shape[1])
    lens = [cfg.encoder.conv_output_length(int(m.sum())) for m in amask]
    feat = (np.arange(T0)[None] < np.asarray(lens)[:, None]).astype(int)
    mti = compute_mask_indices((B, T0), 0.05, 10, attention_mask=feat,
                               min_masks=2, rng=np.random.default_rng(seed))
    keys = ["decoder_input_ids", "ce_labels"]
    if cfg.talker_ctc:
        keys += ["label_spks", "label_spk_lens"]
    return {"input_values": wav, "audio_mask": amask,
            "mask_time_indices": mti, **{k: np.asarray(arr[k])
                                         for k in keys}}


def _jax_mesh(dp, tp):
    import jax

    from mtasr_tpu.parallel.mesh import make_mesh
    return make_mesh(dp, tp, devices=jax.devices()[:dp * tp])


def _sharded(params, batch, mesh):
    import jax.numpy as jnp

    from mtasr_tpu.parallel.mesh import shard_batch, shard_params
    return shard_params(params, mesh), shard_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}, mesh)


# ---------------------------------------------------------------------------
# the scenarios the dp2 x tp2 ranks run, started once for the module
# ---------------------------------------------------------------------------
TRAIN_TC = dict(learning_rate=1e-3, warmup_steps=0, max_steps=10,
                weight_decay=0.01, max_grad_norm=1.0)


def _scenarios(tmp):
    from mtasr_tpu.utils.quantize import quantize_for_serving
    from tests.test_torch_family_slice import family
    from tests.test_torch_quantize import int8_cfg
    sc, ref = {}, {}
    # bf16 route (float32 on the CPU): greedy with a padded row
    cfg = _tiny(train_mode="attention")
    params = _params(cfg, decoder_scale=8.0)
    wav, amask = _wav()
    ref["greedy"] = (cfg, params, wav, amask)
    sc["greedy"] = dict(kind="serve", route="greedy", cfg=_port(cfg),
                        flat=_flat(params), wav=wav, amask=amask,
                        gen=tconfig.GenerationConfig(), max_new_tokens=10,
                        mesh=MESH)
    sc["beam"] = dict(sc["greedy"], route="beam", num_beams=2,
                      max_new_tokens=6)
    # int8: w8a8 decoder + int8 KV cache
    icfg = int8_cfg()
    icfg.encoder = dataclasses.replace(icfg.encoder, num_attention_heads=4)
    iparams = quantize_for_serving(_params(icfg, seed=3), mode="w8a8")
    ref["int8"] = (icfg, iparams, wav, amask)
    sc["int8"] = dict(kind="serve", route="greedy", cfg=_port(icfg),
                      flat=_flat(iparams), wav=wav, amask=amask,
                      gen=tconfig.GenerationConfig(kv_quant=True),
                      max_new_tokens=8, mesh=MESH)
    # the CTC heads: one-shot decode, speculative drafts
    hcfg = _hybrid()
    hparams = _params(hcfg, seed=4, decoder_scale=8.0)
    ref["ctc"] = (hcfg, hparams, wav, amask)
    sc["ctc"] = dict(kind="serve", route="ctc", cfg=_port(hcfg),
                     flat=_flat(hparams), wav=wav, amask=amask,
                     max_new_tokens=20, mesh=MESH)
    sc["spec"] = dict(sc["ctc"], route="greedy", max_new_tokens=10,
                      gen=tconfig.GenerationConfig(speculative="ctc",
                                                   spec_k=3))
    # the family: ctcaware adapters over CTC-token memory, CTC prompt
    fcfg = family("ctcaware", "ctctoken", "ctcprompt", True)
    fcfg.encoder = dataclasses.replace(fcfg.encoder, num_attention_heads=4)
    fparams = _params(fcfg, seed=5, decoder_scale=8.0)
    ref["family"] = (fcfg, fparams, wav, amask)
    sc["family"] = dict(kind="serve", route="greedy", cfg=_port(fcfg),
                        flat=_flat(fparams), wav=wav, amask=amask,
                        gen=tconfig.GenerationConfig(), max_new_tokens=8,
                        mesh=MESH)
    return sc, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The dp2 x tp2 ranks, started in the background (the JAX references
    compute meanwhile), and the references' inputs."""
    tmp = tmp_path_factory.mktemp("parallel")
    sc, ref = _scenarios(tmp)
    job = str(tmp / "job.pt")
    torch.save({"scenarios": sc}, job)
    return Ranks(job, 4), sc, ref


def _same_on_every_rank(res, name, key):
    for r in range(1, len(res)):
        np.testing.assert_array_equal(res[r][name][key], res[0][name][key],
                                      err_msg=f"{name} {key} rank {r}")
    return res[0][name][key]


# ---------------------------------------------------------------------------
# the rule table, make_mesh, initialize
# ---------------------------------------------------------------------------
def _all_names():
    """Names and shapes of the bf16, int8 (w8a8, scope all), hybrid (with
    LoRA) and family models' parameters, by `jax.eval_shape`."""
    import jax

    from mtasr_tpu.models.speech_encoder_decoder import init_model_params
    from mtasr_tpu.train.lora import init_decoder_lora
    from mtasr_tpu.utils.quantize import quantize_for_serving
    from mtasr_tpu.utils.torch_interop import tree_to_flat
    from tests.test_torch_family_slice import FORWARD
    from tests.test_torch_quantize import int8_cfg

    def lora(cfg):
        p = init_model_params(jax.random.key(0), cfg)
        p["decoder_lora"] = init_decoder_lora(jax.random.key(1),
                                              p["decoder"], r=4, alpha=8.0)
        return p
    makers = [lambda f=f: init_model_params(jax.random.key(0), f())
              for f in FORWARD.values()]
    makers += [lambda: lora(_hybrid()), lambda: lora(_attention()),
               lambda: quantize_for_serving(init_model_params(
                   jax.random.key(0), int8_cfg()), mode="w8a8",
                   scope="all")]
    names = {}
    for make in makers:
        tree = jax.eval_shape(make)
        names.update({k: tuple(v.shape) for k, v in
                      tree_to_flat(tree).items()})
    return names


def test_rule_table_matches_jax_spec_for_path():
    from mtasr_tpu.parallel.mesh import spec_for_path
    names = _all_names()
    deviating = []
    for name in names:
        want = tuple(spec_for_path(name.replace(".", "/")))
        got = tmesh.spec_for_name(name)
        if got != want:
            deviating.append(name)
    # the one deviation of the table: the adapters' q/k/v (DEVIATIONS)
    assert deviating and all(
        n.startswith("cross_att_adap.") and n.split(".")[2] in
        ("q_proj", "k_proj", "v_proj") for n in deviating), deviating
    assert "cross_att_adap.*.{q,k,v}_proj" in tmesh.DEVIATIONS


def test_layout_shards_whole_units_and_falls_back():
    import jax

    from mtasr_tpu.models.speech_encoder_decoder import init_model_params
    from mtasr_tpu.utils.quantize import quantize_for_serving
    from tests.test_torch_quantize import int8_cfg
    cfg = _hybrid()
    shapes = {k: v.shape for k, v in _flat(_params(cfg)).items()}
    lay = tmesh.layout(shapes, _port(cfg), 2)
    assert lay["decoder.model.layers.0.self_attn.q_proj.weight"] == 0
    assert lay["decoder.model.layers.1.self_attn.o_proj.weight"] == 1
    assert lay["decoder.model.layers.0.mlp.down_proj.weight"] == 1
    assert lay["decoder.model.embed_tokens.weight"] == 0
    assert lay["encoder.encoder.layers.0.attention.k_proj.bias"] == 0
    assert lay["encoder.encoder.layers.0.feed_forward.output_dense.weight"] \
        == 1
    # the CTC heads' 65 rows do not divide: replicated (the JAX fallback)
    assert not any("ctc_lo" in n for n in lay)
    # every sharded name is sharded by the table, on the table's dim
    for n, d in lay.items():
        assert tmesh.spec_for_name(n)[d] == "model", n
    # 3 kv heads do not divide by 2: the decoder attention stays whole
    cfg3 = _port(cfg)
    cfg3.decoder = dataclasses.replace(cfg3.decoder, num_key_value_heads=3)
    assert not any("self_attn" in n for n in tmesh.layout(shapes, cfg3, 2))
    # an odd vocabulary: the embedding replicated, the CTC heads (64) not
    odd = dict(shapes)
    odd["decoder.model.embed_tokens.weight"] = (63, 24)
    for k in ("weight", "bias"):
        for h in (0, 1):
            n = f"serialized_ctc.{h}.ctc_lo.{k}"
            odd[n] = (64,) + tuple(shapes[n][1:])
    lay = tmesh.layout(odd, _port(cfg), 2)
    assert "decoder.model.embed_tokens.weight" not in lay
    assert lay["serialized_ctc.1.ctc_lo.bias"] == 0
    # int8: the quantized units whole, the float embedding sharded
    from mtasr_tpu.utils.torch_interop import tree_to_flat
    icfg = int8_cfg()
    q = jax.eval_shape(lambda: quantize_for_serving(
        init_model_params(jax.random.key(0), icfg), mode="w8a8"))
    q = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), q)
    lay = tmesh.layout({k: v.shape for k, v in tree_to_flat(q).items()},
                       _port(icfg), 2)
    assert not any(".layers." in n and "decoder" in n for n in lay)
    assert lay["decoder.model.embed_tokens.weight"] == 0


def test_make_mesh_refuses_a_grid_that_does_not_cover_the_world():
    # one process, no group: only 1 x 1 (or -1 x 1) covers it, as
    # `mesh.py:34` asserts
    assert tmesh.make_mesh(-1, 1).size == 1
    for dp, tp in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_mesh(dp, tp)


def test_initialize_contract(monkeypatch):
    import torch.distributed as dist
    calls = []

    def boom(**kw):
        calls.append(kw)
        raise ValueError("bad coordinator")
    monkeypatch.setattr(dist, "init_process_group", boom)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    # explicit arguments: a failure surfaces
    with pytest.raises(ValueError, match="bad coordinator"):
        multihost.initialize("localhost:1", 2, 0, device="cpu")
    assert calls[-1]["backend"] == "gloo"
    # no launcher environment, no arguments: one process, nothing joined
    n = len(calls)
    multihost.initialize(device="cpu")
    multihost.initialize("localhost:1", 1, 0, device="cpu")
    assert len(calls) == n
    assert multihost.process_count() == 1
    assert multihost.process_shard(5) == slice(0, 5)
    x = np.arange(3.0)
    assert multihost.host_broadcast(x) is x
    # already initialized: benign, nothing joined again
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    multihost.initialize("localhost:1", 2, 0, device="cpu")
    assert len(calls) == n
    assert multihost.default_backend("cuda:0") == "nccl"


def test_two_ranks_collectives_multihost_and_dp2_training(tmp_path):
    """The region operators and the collectives against one process, the
    `_multihost_worker.py` flow, a dp = 2 attention step (SpecAugment
    masks on) against the port in one process, and dp = 2 sampling: the
    tokens drawn once for the gathered batch from one seeded generator are
    one process's draws (the dp indices step together)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    cfg = _attention()
    params = _params(cfg, seed=8, lora=True)
    batches = [_train_batch(cfg, seed=30 + i) for i in range(2)]
    train = dict(kind="train", cfg=_port(cfg), flat=_flat(params),
                 training=True, tc=tconfig.TrainingConfig(
                     pcgrad=False, **TRAIN_TC, output_dir=str(tmp_path)),
                 freeze=dict(freeze_decoder=True), batches=batches,
                 mesh=(2, 1))
    scfg = _tiny(train_mode="attention")
    wav, amask = _wav()
    sample = dict(kind="serve", route="greedy", cfg=_port(scfg),
                  flat=_flat(_params(scfg, seed=9, decoder_scale=8.0)),
                  wav=wav, amask=amask, max_new_tokens=10, sample_seed=3,
                  gen=tconfig.GenerationConfig(do_sample=True, top_k=20),
                  mesh=(2, 1))
    job = str(tmp_path / "job.pt")
    torch.save({"scenarios": {
        "coll": dict(kind="collectives", x=x, w=w),
        "mh": dict(kind="multihost", outdir=str(tmp_path)),
        "dp2": train, "sample": sample}}, job)
    ranks = Ranks(job, 2)
    from tests._torch_parallel_worker import run_serve, run_train
    single = run_train(dict(train, mesh=(1, 1)))
    drawn = run_serve(dict(sample, mesh=(1, 1)))["sequences"]
    res = ranks.results()
    for r in range(2):
        np.testing.assert_array_equal(res[r]["sample"]["sequences"], drawn)
    greedy = run_serve(dict(sample, mesh=(1, 1),
                            gen=tconfig.GenerationConfig()))
    assert not np.array_equal(drawn, greedy["sequences"])
    n = 2
    for r in range(n):
        c = res[r]["coll"]
        rows = slice(2 * r, 2 * r + 2)
        # copy: forward identity; the input's gradient sums every rank's
        np.testing.assert_array_equal(c["copy_fwd"], x * np.tile(
            w[rows], (n, 1)))
        np.testing.assert_allclose(c["copy_grad"], sum(
            np.tile(w[2 * q:2 * q + 2], (n, 1)) for q in range(n)),
            rtol=1e-6)
        # reduce: forward sums x * (q + 1); backward the identity
        np.testing.assert_allclose(c["reduce_fwd"], x * 3, rtol=1e-6)
        np.testing.assert_allclose(c["reduce_grad"], w * (r + 1), rtol=1e-6)
        # gather: every rank's rows; backward this rank's slice
        np.testing.assert_array_equal(c["gather_fwd"], x)
        np.testing.assert_array_equal(c["gather_grad"], w[rows])
        # scatter: this rank's rows; backward gathers every rank's
        np.testing.assert_array_equal(c["scatter_fwd"], x[rows])
        np.testing.assert_array_equal(c["scatter_grad"], w)
        # bf16 summed in float32, rounded once
        xb = torch.from_numpy(x).to(torch.bfloat16).float()
        np.testing.assert_array_equal(
            c["allreduce_bf16"], (xb * 3).to(torch.bfloat16).float().numpy())
        np.testing.assert_array_equal(c["broadcast"], x * 2)
    # multihost: contiguous disjoint shards, rank 0's array everywhere,
    # the rank-0 merge covering every utterance once
    assert res[0]["mh"]["mine"] + res[1]["mh"]["mine"] == list(range(11))
    for r in range(n):
        np.testing.assert_array_equal(res[r]["mh"]["broadcast"],
                                      np.arange(4.0) + 1.0)
    assert "Overall" in res[0]["mh"]["report"]
    assert "0.00" in res[0]["mh"]["report"]
    with open(tmp_path / "decod") as f:
        assert [ln.split()[0] for ln in f] == [f"utt{i:02d}"
                                               for i in range(11)]
    # dp = 2 equals one process (SpecAugment masks drawn on the host)
    _compare_train(res[0]["dp2"], single, 2)
    _compare_train(res[1]["dp2"], single, 2)


def _compare_train(got, want, n_steps, gnorm_rtol=GNORM_RTOL):
    for s in range(n_steps):
        for k in ("loss", "loss_attn", "loss_ctc"):
            if k in want["metrics"][s]:
                np.testing.assert_allclose(got["metrics"][s][k],
                                           want["metrics"][s][k],
                                           rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(got["metrics"][s]["grad_norm"],
                                   want["metrics"][s]["grad_norm"],
                                   rtol=gnorm_rtol)
        assert set(got["params"][s]) == set(want["params"][s])
        for k, v in want["params"][s].items():
            np.testing.assert_allclose(got["params"][s][k], v, rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{k} step {s + 1}")


# ---------------------------------------------------------------------------
# serving at dp2 x tp2 against JAX's mesh
# ---------------------------------------------------------------------------
def _jax_generate(name, ref, **kw):
    from mtasr_tpu.config import GenerationConfig
    from mtasr_tpu.generate import generate
    cfg, params, wav, amask = ref[name]
    p, b = _sharded(params, {"w": wav, "m": amask}, _jax_mesh(*MESH))
    gen = kw.pop("gen", None) or GenerationConfig()
    return generate(p, cfg, b["w"], b["m"], gen=gen, **kw)


def test_greedy_tokens_and_step_logits_match_jax_mesh(ranks):
    from mtasr_tpu.models.speech_encoder_decoder import model_forward
    job, sc, ref = ranks
    want = _jax_generate("greedy", ref, max_new_tokens=10)
    cfg, params, wav, amask = ref["greedy"]
    # the prefill's logits and the first decode steps' are the
    # teacher-forced forward's over [BOS | speech | tokens] on the
    # unpadded rows (0-2)
    seqs = np.asarray(want.sequences)
    ids = np.concatenate([np.full((4, 1), cfg.decoder_start_token_id),
                          seqs[:, :2]], 1)
    p, b = _sharded(params, {"w": wav, "m": np.ones_like(amask),
                             "ids": ids}, _jax_mesh(*MESH))
    tf = np.asarray(model_forward(p, cfg, b["w"], b["m"], b["ids"]).logits)
    res = job.results()
    np.testing.assert_array_equal(_same_on_every_rank(res, "greedy",
                                                      "sequences"), seqs)
    Ts = tf.shape[1] - ids.shape[1] + 1
    for j, got in enumerate(res[0]["greedy"]["logits"]):
        np.testing.assert_allclose(got[:3], tf[:3, Ts - 1 + j], rtol=1e-5,
                                   atol=LOGITS_ATOL, err_msg=f"step {j}")
    assert len(set(map(tuple, seqs[:, :4]))) > 1 or len(set(seqs[0])) > 1


def test_int8_route_matches_jax_mesh(ranks):
    from mtasr_tpu.config import GenerationConfig
    job, sc, ref = ranks
    want = _jax_generate("int8", ref, max_new_tokens=8,
                         gen=GenerationConfig(kv_quant=True))
    res = job.results()
    np.testing.assert_array_equal(
        _same_on_every_rank(res, "int8", "sequences"),
        np.asarray(want.sequences))


def test_beam_w2_matches_jax_mesh(ranks):
    from mtasr_tpu.generate.beam import beam_generate
    job, sc, ref = ranks
    cfg, params, wav, amask = ref["greedy"]
    p, b = _sharded(params, {"w": wav, "m": amask}, _jax_mesh(*MESH))
    want = beam_generate(p, cfg, b["w"], b["m"], num_beams=2,
                         max_new_tokens=6)
    res = job.results()
    np.testing.assert_array_equal(_same_on_every_rank(res, "beam",
                                                      "sequences"),
                                  np.asarray(want.sequences))
    np.testing.assert_allclose(res[0]["beam"]["scores"],
                               np.asarray(want.scores), atol=SCORE_ATOL)


def test_speculative_and_ctc_match_jax_mesh(ranks):
    from mtasr_tpu.config import GenerationConfig
    from mtasr_tpu.generate import generate_ctc
    job, sc, ref = ranks
    spec = _jax_generate("ctc", ref, max_new_tokens=10,
                         gen=GenerationConfig(speculative="ctc", spec_k=3))
    cfg, params, wav, amask = ref["ctc"]
    p, b = _sharded(params, {"w": wav, "m": amask}, _jax_mesh(*MESH))
    trans, lens = generate_ctc(p, cfg, b["w"], b["m"], max_out_len=20)
    res = job.results()
    np.testing.assert_array_equal(_same_on_every_rank(res, "spec",
                                                      "sequences"),
                                  np.asarray(spec.sequences))
    np.testing.assert_array_equal(_same_on_every_rank(res, "ctc",
                                                      "sequences"),
                                  np.asarray(trans))
    np.testing.assert_array_equal(res[0]["ctc"]["lengths"],
                                  np.asarray(lens))


def test_ctcaware_family_matches_jax_mesh(ranks):
    job, sc, ref = ranks
    want = _jax_generate("family", ref, max_new_tokens=8)
    res = job.results()
    np.testing.assert_array_equal(
        _same_on_every_rank(res, "family", "sequences"),
        np.asarray(want.sequences))
