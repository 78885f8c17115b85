"""The port's corpus pipeline and checkpoints (CPU).

``AsrDataset`` batches equal JAX's on the same corpus (token_ids,
loss_mask, n_frames and n_audio exactly; the log-mel within atol 1e-4,
the port's mel tolerance, ``test_torch_mel.py``), with the language open
and forced. Beside that, every case of ``tests/test_training_data.py``
on the port: manifests, static shapes and masks, language targets, a
train step over prefetched loader batches, sharded lockstep (unreadable
audio, manifest durations, bucket-homogeneous steps, an inaccurate
duration), and the checkpoints: a save/restore round trip that resumes
identically, the async checkpointer's round trip, non-blocking saves,
best-k, rollback-resume pruning and its journal.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.training import data as jdata
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.runtime.prompt import PROMPT_HEADER, build_prompt
from qwen3_asr_rs_tpu_torch.tokenizer import (
    ASR_TEXT_TOKEN_ID,
    IM_END_TOKEN_ID,
)
from qwen3_asr_rs_tpu_torch.training import (
    AsrDataset,
    AsyncTrainCheckpointer,
    TrainState,
    adamw,
    make_train_step,
    prefetch_to_device,
    read_manifest,
    restore_train_state,
    save_train_state,
    sgd,
)
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params,
    init_encoder_params,
)

from test_audio_io import write_wav_pcm16
from test_engine_e2e import MockTokenizer
from test_training import make_batch

LENGTHS = [(8000, None), (16000, "english"), (9000, None),
           (24000, "chinese"), (7000, None)]


def _write_corpus(root, rng, lengths=LENGTHS, durations=False):
    rows = []
    for i, (n, lang) in enumerate(lengths):
        p = root / f"clip{i}.wav"
        write_wav_pcm16(p, (rng.standard_normal(n) * 0.1), 16000)
        rows.append({"audio": p.name, "text": f"hello world {i}",
                     **({"language": lang} if lang else {}),
                     **({"duration": n / 16000} if durations else {})})
    manifest = root / "train.jsonl"
    manifest.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return manifest


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Manifest with 5 clips across two buckets (two with a language);
    tests that change files take a copy (``corpus_copy``)."""
    return _write_corpus(tmp_path_factory.mktemp("corpus"),
                         np.random.default_rng(0))


@pytest.fixture()
def corpus_copy(corpus, tmp_path):
    shutil.copytree(corpus.parent, tmp_path / "c")
    return tmp_path / "c" / corpus.name


def _kw(**kw):
    return dict(tokenizer=MockTokenizer(), config=tconfig.tiny_test_config(),
                chunk_buckets=(2, 4), max_text_tokens=16, **kw)


@pytest.mark.parametrize("forced", [False, True])
def test_batches_match_jax(corpus, forced):
    kw = dict(chunk_buckets=(2, 4), batch_size=2, max_text_tokens=32,
              seed=5, forced_language=forced)
    want = list(jdata.AsrDataset(corpus, MockTokenizer(),
                                 config=jconfig.tiny_test_config(),
                                 **kw).batches(epochs=2))
    got = list(AsrDataset(corpus, MockTokenizer(),
                          config=tconfig.tiny_test_config(),
                          **kw).batches(epochs=2))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("token_ids", "loss_mask", "n_frames", "n_audio"):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["mel"].shape == w["mel"].shape
        assert g["mel"].dtype == np.float32
        np.testing.assert_allclose(g["mel"], w["mel"], atol=1e-4, rtol=0)


def test_sharded_batches_match_jax(corpus):
    kw = dict(chunk_buckets=(2, 4), batch_size=1, max_text_tokens=16,
              seed=3, num_shards=2)
    for i in range(2):
        want = list(jdata.AsrDataset(corpus, MockTokenizer(),
                                     config=jconfig.tiny_test_config(),
                                     shard_index=i, **kw).batches())
        got = list(AsrDataset(corpus, MockTokenizer(),
                              config=tconfig.tiny_test_config(),
                              shard_index=i, **kw).batches())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["token_ids"], w["token_ids"])
            np.testing.assert_array_equal(g["loss_mask"], w["loss_mask"])


def test_read_manifest_resolves_paths(corpus):
    utts = read_manifest(corpus)
    assert len(utts) == 5
    assert all(u.audio.exists() for u in utts)
    assert utts[1].language == "english"


def test_read_manifest_rejects_bad_lines(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"audio": "x.wav"}\n')  # missing text
    with pytest.raises(ValueError, match="bad manifest line"):
        read_manifest(bad)


def test_batches_static_shapes_and_masks(corpus):
    cfg = tconfig.tiny_test_config()
    ds = AsrDataset(corpus, MockTokenizer(), config=cfg,
                    chunk_buckets=(2, 4), batch_size=2, max_text_tokens=32)
    batches = list(ds.batches())
    assert batches, "no batches emitted"
    cf = cfg.audio.chunk_frames
    for b in batches:
        bsz, bins, frames = b["mel"].shape
        assert bsz == 2 and bins == cfg.audio.num_mel_bins
        assert frames % cf == 0
        assert b["token_ids"].shape == b["loss_mask"].shape
        assert b["token_ids"].shape[1] % 16 == 0
        np.testing.assert_array_equal(
            b["token_ids"][0, : len(PROMPT_HEADER)], PROMPT_HEADER)
        for r in range(bsz):
            m = b["loss_mask"][r]
            if m.sum() == 0:
                continue  # collate filler row
            last = int(np.nonzero(m)[0][-1])
            assert b["token_ids"][r, last + 1] == IM_END_TOKEN_ID
            first = int(np.nonzero(m)[0][0])
            prompt = build_prompt(int(b["n_audio"][r]), None, MockTokenizer())
            assert first == len(prompt) - 1
    assert sum(int((b["loss_mask"].sum(axis=1) > 0).sum())
               for b in batches) == 5


def test_language_rows_train_the_language_tag(corpus):
    ds = AsrDataset(corpus, MockTokenizer(), config=tconfig.tiny_test_config(),
                    chunk_buckets=(2, 4), batch_size=1, max_text_tokens=32)
    seen_asr_text = False
    for b in ds.batches():
        ids = b["token_ids"][0]
        if (ids == ASR_TEXT_TOKEN_ID).any():
            seen_asr_text = True
            pos = int(np.nonzero(ids == ASR_TEXT_TOKEN_ID)[0][0])
            assert b["loss_mask"][0, pos - 1] == 1.0  # tag is a target
    assert seen_asr_text


def _vocab_cfg():
    """tiny config with the real vocab so special-token ids embed."""
    cfg = tconfig.tiny_test_config()
    text = dataclasses.replace(cfg.text, vocab_size=151936)
    return dataclasses.replace(
        cfg, thinker_config=dataclasses.replace(cfg.thinker_config,
                                                text_config=text))


def _params(cfg):
    return {"encoder": init_encoder_params(cfg.audio, dtype=torch.float32),
            "decoder": init_decoder_params(cfg.text, dtype=torch.float32)}


def test_train_step_consumes_loader_batches(corpus):
    cfg = _vocab_cfg()
    ds = AsrDataset(corpus, MockTokenizer(), config=cfg,
                    chunk_buckets=(2, 4), batch_size=2, max_text_tokens=16)
    opt = adamw(1e-3)
    step = make_train_step(cfg, opt, max_position=256, device="cpu")
    state = step.init(_params(cfg))
    losses = []
    for batch in prefetch_to_device(ds.batches(), size=2, device="cpu"):
        assert all(isinstance(t, torch.Tensor) for t in batch.values())
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses and all(np.isfinite(losses))
    assert state.step == len(losses)


def test_prefetch_raises_producer_errors():
    def batches():
        yield {"x": np.zeros(3, np.float32)}
        raise ValueError("bad clip")

    it = prefetch_to_device(batches(), size=1, device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(3))
    with pytest.raises(ValueError, match="bad clip"):
        next(it)


def test_checkpoint_roundtrip(tmp_path):
    """save/restore round-trips every leaf and the optimizer state, and
    training resumes identically."""
    jcfg = jconfig.tiny_test_config()
    cfg = tconfig.tiny_test_config()
    step = make_train_step(cfg, adamw(1e-3), max_position=256, device="cpu")
    state = step.init(_params(cfg))
    batch = make_batch(jcfg, 2, np.random.default_rng(0))
    state, _ = step(state, batch)

    save_train_state(tmp_path / "ckpt", state)
    template = step.init(_params(cfg))
    with torch.no_grad():
        for t in template.optimizer.param_groups[0]["params"]:
            t.zero_()
    restored = restore_train_state(tmp_path / "ckpt", template)
    assert restored.step == state.step == 1
    for a, b in zip(state.optimizer.param_groups[0]["params"],
                    restored.optimizer.param_groups[0]["params"]):
        assert torch.equal(a, b)
    for a, b in zip(state.optimizer.state.values(),
                    restored.optimizer.state.values()):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)

    _, l1 = step(state, batch)
    _, l2 = step(restored, batch)
    assert float(l1) == float(l2)


def _tiny_state(step=0, opt=None):
    return TrainState.create({"w": torch.ones(4)}, opt or sgd(1e-2), step)


def test_async_checkpointer_roundtrip(tmp_path):
    cfg = tconfig.tiny_test_config()
    state = TrainState.create(_params(cfg), adamw(1e-3))
    ck = AsyncTrainCheckpointer(tmp_path / "ckpts", max_to_keep=2)
    for s in (1, 2, 3):
        ck.save(dataclasses.replace(state, step=s))
    ck.wait()
    assert ck.latest().name == "step_00000003"
    assert len(list((tmp_path / "ckpts").glob("step_*"))) == 2

    template = TrainState.create(_params(cfg), adamw(1e-3))
    with torch.no_grad():
        template.params["decoder"]["final_ln_w"].zero_()
    restored = ck.restore_latest(template)
    assert restored.step == 3
    torch.testing.assert_close(restored.params["decoder"]["final_ln_w"],
                               state.params["decoder"]["final_ln_w"])
    ck.close()


def test_async_checkpointer_saves_a_snapshot(tmp_path):
    """save() copies the state before it returns: an in-place update
    right after it does not reach the file."""
    state = _tiny_state(1)
    ck = AsyncTrainCheckpointer(tmp_path, max_to_keep=2)
    ck.save(state)
    with torch.no_grad():
        state.params["w"].fill_(7.0)
    restored = ck.restore_latest(_tiny_state())
    assert torch.equal(restored.params["w"], torch.ones(4))
    ck.close()


def test_dataset_sharding_partitions_manifest(corpus):
    trained, counts = [], []
    for i in range(2):
        ds = AsrDataset(corpus, shard_index=i, num_shards=2, batch_size=1,
                        seed=3, **_kw())
        batches = list(ds.batches())
        counts.append(len(batches))
        texts = set()
        for b in batches:
            for r in range(b["loss_mask"].shape[0]):
                if b["loss_mask"][r].sum() > 0:
                    texts.add(tuple(np.asarray(b["token_ids"][r]).tolist()))
        trained.append(texts)
    assert counts[0] == counts[1]
    assert not (trained[0] & trained[1])
    assert len(trained[0]) + len(trained[1]) == 5
    with pytest.raises(ValueError):
        AsrDataset(corpus, shard_index=2, num_shards=2, batch_size=1, **_kw())


def test_sharded_batches_lockstep_with_unreadable_audio(corpus_copy):
    """A mid-epoch unreadable file is substituted with a zero-loss
    filler, never skipped: shard batch counts stay identical."""
    kw = dict(batch_size=2, seed=0, **_kw())
    baseline = [len(list(AsrDataset(corpus_copy, shard_index=i, num_shards=2,
                                    **kw).batches())) for i in range(2)]
    assert baseline[0] == baseline[1]
    counts = []
    for i in range(2):
        ds = AsrDataset(corpus_copy, shard_index=i, num_shards=2, **kw)
        for j in range(len(ds.utts)):
            ds._bucket_of(j)  # populate the probe cache
        victim = ds.utts[0].audio
        data = victim.read_bytes()
        victim.write_bytes(b"not a wav file")
        try:
            batches = list(ds.batches())
        finally:
            victim.write_bytes(data)
        counts.append(len(batches))
        for b in batches:
            assert b["token_ids"].shape[0] == 2
    assert counts == baseline


def test_sharded_batches_use_manifest_duration(tmp_path, monkeypatch):
    """With 'duration' in the manifest the scheduler never probes audio."""
    manifest = _write_corpus(tmp_path, np.random.default_rng(1),
                             durations=True)
    ds = AsrDataset(manifest, batch_size=2, shard_index=0, num_shards=2,
                    **_kw())
    import qwen3_asr_rs_tpu_torch.audio.load as load_mod

    calls = []
    real_load = load_mod.load_audio
    monkeypatch.setattr(load_mod, "load_audio",
                        lambda *a, **k: calls.append(a) or real_load(*a, **k))
    for j in range(len(ds.utts)):
        assert ds._bucket_of(j) in (2, 4)
    assert not calls, "duration-annotated utterances must not be probed"


def test_sharded_steps_are_bucket_homogeneous(tmp_path):
    manifest = _write_corpus(
        tmp_path, np.random.default_rng(2),
        [(n, None) for n in (8000, 16000, 50000, 9000, 60000, 7000, 55000)])
    per_shard = []
    for i in range(2):
        ds = AsrDataset(manifest, shard_index=i, num_shards=2, batch_size=1,
                        seed=3, **_kw())
        per_shard.append([b["mel"].shape[-1] for b in ds.batches(epochs=2)])
    assert len(per_shard[0]) == len(per_shard[1])
    assert per_shard[0] == per_shard[1]  # same bucket shape every step
    assert len(set(per_shard[0])) > 1   # corpus genuinely spans buckets


def test_inaccurate_manifest_duration_still_trains(tmp_path):
    p = tmp_path / "clip.wav"
    write_wav_pcm16(p, np.random.default_rng(3).standard_normal(31000) * 0.1,
                    16000)
    manifest = tmp_path / "train.jsonl"
    # true bucket at 31000 samples is 2 chunks; duration 2.6 s probes 4
    manifest.write_text(json.dumps(
        {"audio": p.name, "text": "hello", "duration": 2.6}) + "\n")
    trained = 0
    for i in range(2):
        ds = AsrDataset(manifest, shard_index=i, num_shards=2, batch_size=1,
                        seed=0, **_kw())
        trained += sum(b["loss_mask"].sum() > 0 for b in ds.batches())
    assert trained == 1  # one real batch across both shards, not filler


def test_async_checkpointer_steady_state_nonblocking(tmp_path):
    """Pruning runs before the next write starts and never joins the
    writer itself (save() waits only for the previous write)."""
    state = _tiny_state()
    ck = AsyncTrainCheckpointer(tmp_path / "ck", max_to_keep=2)
    waits = []
    real_gc = ck._gc

    def counting_gc():
        orig = ck._ckptr.wait_until_finished
        ck._ckptr.wait_until_finished = lambda: waits.append(1) or orig()
        try:
            real_gc()
        finally:
            ck._ckptr.wait_until_finished = orig

    ck._gc = counting_gc
    for s in range(1, 7):
        ck.save(dataclasses.replace(state, step=s))
    assert not waits, "pruning joined the async writer"
    ck.wait()
    kept = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert kept == ["step_00000005", "step_00000006"]
    ck.close()


def test_async_checkpointer_best_k(tmp_path):
    state = _tiny_state()
    ck = AsyncTrainCheckpointer(tmp_path / "ck", max_to_keep=2, keep_best=1)
    for step, loss in {1: 5.0, 2: 1.5, 3: 4.0, 4: 3.0, 5: 2.0}.items():
        ck.save(dataclasses.replace(state, step=step), metric=loss)
    ck.wait()
    kept = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert kept == ["step_00000002", "step_00000004", "step_00000005"]
    assert ck.best().name == "step_00000002"
    assert ck.restore_best(state).step == 2
    ck.close()


def test_checkpoint_rollback_resume_prunes_correctly(tmp_path):
    """After restoring an EARLIER step and resuming, recency retention
    keeps the newly written checkpoints (save order, not numeric)."""
    ck = AsyncTrainCheckpointer(tmp_path, max_to_keep=2)
    for s in (2, 99, 100):
        ck.save(_tiny_state(s))
    ck.close()

    ck2 = AsyncTrainCheckpointer(tmp_path, max_to_keep=2)
    for s in (3, 4):
        ck2.save(_tiny_state(s))
    ck2.wait()
    ck2._gc()
    kept = {p.name for p in ck2._step_dirs()}
    ck2.close()
    assert "step_00000003" in kept and "step_00000004" in kept
    assert "step_00000099" not in kept and "step_00000100" not in kept


def test_checkpoint_journal_drops_pruned_entries(tmp_path):
    ck = AsyncTrainCheckpointer(tmp_path, max_to_keep=1, keep_best=1)
    ck.save(_tiny_state(1), metric=5.0)
    ck.save(_tiny_state(2), metric=1.0)  # the best
    ck.save(_tiny_state(3), metric=9.0)
    ck.wait()
    ck._gc()
    ck.close()
    journal = json.loads((tmp_path / "metrics.json").read_text())
    on_disk = {int(p.name.split("_")[1]) for p in ck._step_dirs()}
    assert set(map(int, journal)) <= on_disk
    assert 2 in on_disk  # best survived

    # a corrupt journal must not poison the next constructor
    (tmp_path / "metrics.json").write_text('{"truncated')
    AsyncTrainCheckpointer(tmp_path, max_to_keep=1).close()
