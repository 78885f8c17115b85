"""ASR corpus data pipeline for fine-tuning.

Port of ``qwen3_asr_rs_tpu/training/data.py``: every emitted batch has a
static shape drawn from a small set of (chunk-bucket, batch) pairs, the
same buckets as serving's encoder shapes.

Manifest format: JSON-lines, one utterance per line::

    {"audio": "clips/a.wav", "text": "hello world", "language": "english"}

Relative audio paths resolve against the manifest's directory. ``language``
is optional; ``duration`` (seconds) lets a sharded schedule skip probing
the audio.

Design (as in JAX):
  * audio loads through the same chain as inference (``audio/load.py``)
    and is padded to a chunk bucket;
  * log-mels are computed on the host CPU with the inference mel code
    (``features/mel.py``), so training sees serving's features;
  * prompts are token-exact with inference (``runtime/prompt.build_prompt``).
    With ``forced_language=False`` (default) the prompt leaves the
    language open and the target includes ``language {Lang}<asr_text>``
    when the manifest provides a language; with ``forced_language=True``
    the language goes into the prompt and only the transcript is trained;
  * loss_mask marks positions whose NEXT token is a target (teacher
    forcing), matching ``training.train_step.asr_loss``;
  * batches group same-bucket utterances, shuffled per epoch with a
    seeded rng; ``prefetch_to_device`` copies batches to the device from
    a thread while the consumer trains.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..config import AsrConfig, audio_tokens
from ..features.mel import (
    create_mel_filterbank,
    log_mel_from_padded,
    num_mel_frames,
    pad_waveform,
)
from ..parallel.comm import mesh_axis
from ..runtime.prompt import (
    AUDIO_OFFSET,
    build_prompt,
    capitalize_first,
)
from ..tokenizer import (
    ASR_TEXT_TOKEN_ID,
    ENDOFTEXT_TOKEN_ID,
    IM_END_TOKEN_ID,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Utterance:
    audio: Path
    text: str
    language: Optional[str] = None
    # optional duration in seconds (manifest key "duration"); when
    # present, multi-host sharding can build its global batch schedule
    # without probing the audio files
    duration: Optional[float] = None


def read_manifest(path: str | Path) -> list[Utterance]:
    """Parse a JSONL manifest; audio paths resolve against its directory."""
    path = Path(path)
    utts = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                audio = Path(row["audio"])
                if not audio.is_absolute():
                    audio = path.parent / audio
                dur = row.get("duration")
                utts.append(
                    Utterance(
                        audio=audio,
                        text=str(row["text"]),
                        language=row.get("language"),
                        duration=None if dur is None else float(dur),
                    )
                )
            except (json.JSONDecodeError, KeyError) as e:
                raise ValueError(
                    f"{path}:{line_no}: bad manifest line: {e}"
                ) from e
    if not utts:
        raise ValueError(f"{path}: empty manifest")
    return utts


class AsrDataset:
    """Bucketed, fixed-shape batch producer over an ASR manifest."""

    def __init__(
        self,
        manifest: str | Path | Sequence[Utterance],
        tokenizer,
        config: Optional[AsrConfig] = None,
        chunk_buckets: Sequence[int] = (4, 8, 15, 30),
        max_text_tokens: int = 128,
        batch_size: int = 8,
        seed: int = 0,
        forced_language: bool = False,
        drop_last: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.utts = (
            read_manifest(manifest)
            if isinstance(manifest, (str, Path))
            else list(manifest)
        )
        self.tokenizer = tokenizer
        self.config = config or AsrConfig()
        self.chunk_buckets = tuple(sorted(chunk_buckets))
        self.max_text_tokens = max_text_tokens
        self.batch_size = batch_size
        self.seed = seed
        self.forced_language = forced_language
        self.drop_last = drop_last
        # Data-parallel sharding across processes: every process builds the
        # SAME global batch schedule (shared seed + per-utterance buckets)
        # and takes a disjoint strided slice of BATCHES, padded so every
        # process yields the same count per epoch (see batches()) — pass
        # shard_index=rank, num_shards=world_size in dp training.
        if not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"{num_shards} shards"
            )
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._filters = torch.from_numpy(
            create_mel_filterbank(self.config.audio.num_mel_bins, 400, 16000)
        )

    # ------------------------------------------------------------------ #

    def _pick_bucket(self, n_frames: int) -> int:
        cf = self.config.audio.chunk_frames
        chunks = -(-n_frames // cf)
        for c in self.chunk_buckets:
            if c >= chunks:
                return c
        raise ValueError(
            f"utterance needs {chunks} chunks > largest bucket "
            f"{self.chunk_buckets[-1]}; raise chunk_buckets or pre-segment"
        )

    def _seq_len(self, bucket: int) -> int:
        """Static token-sequence length for a bucket (16-aligned)."""
        tpc = self.config.audio.tokens_per_chunk
        p = AUDIO_OFFSET + bucket * tpc + 16 + self.max_text_tokens
        return -(-p // 16) * 16

    def _host_mel(self, wave: np.ndarray, n_true_frames: int) -> np.ndarray:
        """Inference-parity log-mel on the host CPU."""
        return log_mel_from_padded(
            torch.from_numpy(wave), n_true_frames, self._filters
        ).numpy()

    def make_example(self, utt: Utterance,
                     min_bucket: Optional[int] = None) -> dict:
        """One utterance -> unbatched example dict + its bucket.

        ``min_bucket``: never pick a smaller bucket (multi-host builds
        pass the schedule's probe bucket — a manifest ``duration``
        rounded slightly low must not change the batch shape; padding
        up to the scheduled bucket is exact).
        """
        from ..audio.load import load_audio

        samples = load_audio(utt.audio, target_sample_rate=16000)
        n_frames = num_mel_frames(len(samples))
        bucket = self._pick_bucket(n_frames)
        if min_bucket is not None and min_bucket > bucket:
            bucket = min_bucket
        cf = self.config.audio.chunk_frames
        wave, n_true = pad_waveform(samples, bucket_frames=bucket * cf)
        n_audio = audio_tokens(self.config.audio, n_true)

        if self.forced_language and utt.language:
            prompt = build_prompt(n_audio, utt.language, self.tokenizer)
            target = list(self.tokenizer.encode(utt.text))
        else:
            prompt = build_prompt(n_audio, None, self.tokenizer)
            target = []
            if utt.language:
                target += list(
                    self.tokenizer.encode(
                        f"language {capitalize_first(utt.language)}"
                    )
                )
                target.append(ASR_TEXT_TOKEN_ID)
            target += list(self.tokenizer.encode(utt.text))
        target.append(IM_END_TOKEN_ID)

        seq_len = self._seq_len(bucket)
        if len(prompt) + len(target) > seq_len:
            target = target[: seq_len - len(prompt) - 1] + [IM_END_TOKEN_ID]
            logger.warning(
                "%s: transcript truncated to fit %d tokens",
                utt.audio, seq_len,
            )
        token_ids = np.full(seq_len, ENDOFTEXT_TOKEN_ID, np.int32)
        token_ids[: len(prompt)] = prompt
        token_ids[len(prompt) : len(prompt) + len(target)] = target
        # position i is trained iff token i+1 is a target token
        loss_mask = np.zeros(seq_len, np.float32)
        loss_mask[len(prompt) - 1 : len(prompt) + len(target) - 1] = 1.0

        mel = self._host_mel(wave, n_true)  # (num_mel_bins, F_bucket)
        return {
            "bucket": bucket,
            "mel": mel.astype(np.float32),
            "n_frames": np.int32(n_true),
            "n_audio": np.int32(n_audio),
            "token_ids": token_ids,
            "loss_mask": loss_mask,
        }

    # ------------------------------------------------------------------ #

    def _null_example(self, bucket: int) -> dict:
        """Shape-compatible silent example contributing zero loss.

        Used as multi-host lockstep filler (schedule padding / unreadable
        audio substitution): zero waveform of exactly ``bucket`` chunks,
        open-language prompt, no target, loss_mask all zero.
        """
        cf = self.config.audio.chunk_frames
        samples = np.zeros(bucket * cf * 160, np.float32)
        wave, n_true = pad_waveform(samples, bucket_frames=bucket * cf)
        n_audio = audio_tokens(self.config.audio, n_true)
        prompt = build_prompt(n_audio, None, self.tokenizer)
        seq_len = self._seq_len(bucket)
        token_ids = np.full(seq_len, ENDOFTEXT_TOKEN_ID, np.int32)
        token_ids[: len(prompt)] = prompt
        return {
            "bucket": bucket,
            "mel": self._host_mel(wave, n_true).astype(np.float32),
            "n_frames": np.int32(n_true),
            "n_audio": np.int32(n_audio),
            "token_ids": token_ids,
            "loss_mask": np.zeros(seq_len, np.float32),
        }

    def _bucket_of(self, idx: int) -> Optional[int]:
        """Bucket for utterance ``idx`` without building the example.

        Prefers the manifest ``duration`` field; otherwise probes the
        audio once (cached). Returns None when the audio is unreadable
        or overflows the largest bucket.
        """
        if not hasattr(self, "_bucket_cache"):
            self._bucket_cache: dict[int, Optional[int]] = {}
        if idx in self._bucket_cache:
            return self._bucket_cache[idx]
        utt = self.utts[idx]
        bucket: Optional[int] = None
        try:
            if utt.duration is not None:
                n_frames = num_mel_frames(int(round(utt.duration * 16000)))
            else:
                from ..audio.load import load_audio

                n_frames = num_mel_frames(
                    len(load_audio(utt.audio, target_sample_rate=16000))
                )
            bucket = self._pick_bucket(max(1, n_frames))
        except Exception as e:  # noqa: BLE001 — excluded globally
            logger.warning("excluding %s from schedule: %s", utt.audio, e)
        self._bucket_cache[idx] = bucket
        return bucket

    def batches(self, epochs: int = 1) -> Iterator[dict]:
        """Yield fixed-shape batch dicts grouped by chunk bucket.

        Every batch is padded to exactly ``batch_size`` examples (the
        pad rows repeat a real example with loss_mask zeroed), so each
        bucket has ONE train-step shape.

        With ``num_shards > 1`` every host yields EXACTLY the same number
        of batches per epoch (lockstep-safe for multi-host dp training):
        all hosts build the same global batch schedule from the shared
        seed + per-utterance buckets (manifest ``duration`` or a one-time
        audio probe — unreadable files are excluded identically on every
        host, assuming a shared dataset), each bucket's batch list is
        padded to a multiple of ``num_shards`` with zero-loss filler
        batches, the schedule is emitted in bucket-HOMOGENEOUS steps
        (all ``num_shards`` batches of a step share one bucket shape, so
        every host runs the same shapes each step), and each
        host takes a strided slice of *batches*, not examples. An
        utterance whose audio fails to build mid-epoch is substituted
        with a zero-loss example instead of skipped, so step counts never
        diverge.
        """
        if self.num_shards > 1:
            yield from self._sharded_batches(epochs)
            return
        rng = np.random.default_rng(self.seed)
        for epoch in range(epochs):
            order = rng.permutation(len(self.utts))
            pending: dict[int, list[dict]] = {}
            for idx in order:
                try:
                    ex = self.make_example(self.utts[idx])
                except Exception as e:  # noqa: BLE001 — skip bad rows
                    logger.warning(
                        "skipping %s: %s", self.utts[idx].audio, e
                    )
                    continue
                group = pending.setdefault(ex["bucket"], [])
                group.append(ex)
                if len(group) == self.batch_size:
                    yield self._collate(group)
                    pending[ex["bucket"]] = []
            if not self.drop_last:
                for group in pending.values():
                    if group:
                        yield self._collate(group)

    def _sharded_batches(self, epochs: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        if any(u.duration is None for u in self.utts):
            logger.warning(
                "multi-host sharding without manifest 'duration' fields: "
                "probing %d audio files to assign buckets (one-time cost; "
                "add durations to the manifest to skip this)",
                sum(u.duration is None for u in self.utts),
            )
        for epoch in range(epochs):
            order = rng.permutation(len(self.utts))
            # global, identical-on-every-host batch schedule, grouped so
            # the num_shards batches consumed at one STEP share a bucket:
            # data-parallel ranks must run the same shapes each step (their
            # gradient collectives pair up tensor by tensor) — equal batch
            # COUNTS alone would still desync the first time rank 0 drew a
            # bucket-2 batch while rank 1 drew bucket-4.
            by_bucket: dict[int, list[tuple[int, list[int], bool]]] = {}
            pending_idx: dict[int, list[int]] = {}
            for idx in order:
                bucket = self._bucket_of(int(idx))
                if bucket is None:
                    continue
                group = pending_idx.setdefault(bucket, [])
                group.append(int(idx))
                if len(group) == self.batch_size:
                    by_bucket.setdefault(bucket, []).append(
                        (bucket, group, False)
                    )
                    pending_idx[bucket] = []
            if not self.drop_last:
                for bucket, group in pending_idx.items():
                    if group:
                        by_bucket.setdefault(bucket, []).append(
                            (bucket, group, False)
                        )
            # pad each bucket's batch list to a shard multiple with
            # zero-loss fillers, then emit bucket-homogeneous steps
            steps: list[list[tuple[int, list[int], bool]]] = []
            for bucket in sorted(by_bucket):
                blist = by_bucket[bucket]
                while len(blist) % self.num_shards:
                    blist.append((bucket, blist[-1][1], True))
                for i in range(0, len(blist), self.num_shards):
                    steps.append(blist[i : i + self.num_shards])
            # shuffle at step granularity (same rng state on every host)
            rng.shuffle(steps)
            schedule = [b for step in steps for b in step]
            for bucket, idxs, zero_loss in schedule[
                self.shard_index :: self.num_shards
            ]:
                yield self._build_batch(bucket, idxs, zero_loss)

    def _build_batch(
        self, bucket: int, idxs: list[int], zero_loss: bool
    ) -> dict:
        group: list[dict] = []
        for idx in idxs:
            try:
                # pad up to the scheduled bucket when the probe's
                # duration rounded low (exact: bucketing IS padding);
                # only audio LONGER than the scheduled bucket — a badly
                # wrong manifest duration — still needs the filler
                ex = self.make_example(self.utts[idx], min_bucket=bucket)
                if ex["bucket"] != bucket:
                    raise ValueError(
                        f"audio exceeds scheduled bucket ({bucket} < "
                        f"{ex['bucket']}); fix the manifest duration"
                    )
            except Exception as e:  # noqa: BLE001 — substitute, not skip
                logger.warning(
                    "substituting zero-loss filler for %s: %s",
                    self.utts[idx].audio, e,
                )
                ex = self._null_example(bucket)
            group.append(ex)
        return self._collate(group, zero_loss=zero_loss)

    def _collate(self, group: list[dict], zero_loss: bool = False) -> dict:
        n_pad = self.batch_size - len(group)
        if n_pad:
            filler = dict(group[-1])
            filler["loss_mask"] = np.zeros_like(filler["loss_mask"])
            group = group + [filler] * n_pad
        if zero_loss:
            group = [
                dict(g, loss_mask=np.zeros_like(g["loss_mask"]))
                for g in group
            ]
        return {
            "mel": np.stack([g["mel"] for g in group]),
            "n_frames": np.stack([g["n_frames"] for g in group]),
            "n_audio": np.stack([g["n_audio"] for g in group]),
            "token_ids": np.stack([g["token_ids"] for g in group]),
            "loss_mask": np.stack([g["loss_mask"] for g in group]),
        }


def dp_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a batch on a mesh: rows [r n, (r + 1) n) of
    every array, n = B / dp, r the rank's dp index (the whole batch
    without a mesh or with dp = 1)."""
    dp = mesh_axis(mesh, "dp")
    if dp is None:
        return batch
    rows = len(next(iter(batch.values())))
    if rows % dp.size:
        raise ValueError(f"a batch of {rows} rows does not divide over "
                         f"dp = {dp.size}")
    n = rows // dp.size
    return {k: v[dp.rank * n:(dp.rank + 1) * n] for k, v in batch.items()}


def prefetch_to_device(
    batches: Iterator[dict],
    size: int = 2,
    device: str | torch.device = "cuda",
    mesh=None,
) -> Iterator[dict]:
    """Stage host batches on ``device`` ahead of the consumer.

    A background thread converts up to ``size`` batches ahead into
    tensors on ``device``: for a CUDA device, from pinned host memory with
    ``non_blocking=True`` copies on the thread's current stream. An
    exception in the producer is raised to the consumer. ``mesh``: each
    batch is cut to this rank's dp rows first (``dp_rows``; JAX's
    ``sharding=``), as a mesh train step takes them.
    """
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    END = object()

    def put(batch):
        batch = dp_rows(batch, mesh)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    def worker():
        try:
            for batch in batches:
                q.put(put(batch))
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            q.put(e)
            return
        q.put(END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, Exception):
            raise item
        yield item
