"""Minimal HTTP serving endpoint (stdlib-only) over continuous batching.

Port of ``qwen3_asr_rs_tpu/runtime/server.py``: the same routes, fields,
status codes and response shapes, over the port's ContinuousBatcher
(``runtime/serving.py``).

POST /transcribe with a WAV (or any decodable) body, optional
``?language=``, ``?max_new=``, ``?temperature=`` and ``?top_p=`` query
params -> JSON {"language", "text"}. GET /healthz for liveness.

POST /v1/audio/transcriptions is an OpenAI-compatible route:
multipart/form-data with a ``file`` field (plus optional ``language``,
``temperature`` (0 = greedy, the default; > 0 samples on the device),
``top_p`` (an extension field: per-request nucleus mass in (0, 1],
ignored at temperature 0 like the OpenAI chat API), ``response_format``
= ``json`` (default) | ``text`` | ``verbose_json``) -> ``{"text": ...}``
/ plain text / ``{"task", "language", "duration", "text", "words",
"segments": [...]}`` with Whisper-shaped time-stamped segments, so
Whisper-API clients can point at this server unchanged.

Requests are admitted into decode slots at segment boundaries and
returned the moment their own decode finishes: a short clip is never
held by a long one.

    python -m qwen3_asr_rs_tpu_torch.runtime.server <model_dir> [port]

runs it on ``ASR_DEVICE`` (default cuda; no CPU fallback).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..audio.load import load_audio
from .engine import AsrEngine
from .serving import ContinuousBatcher, Request, ServingLoop

logger = logging.getLogger(__name__)


class _ServerFault(RuntimeError):
    """A failure after the request was accepted -> HTTP 500."""


class BatchingWorker(ServingLoop):
    """Continuous-batching worker (the JAX server's name and signature).

    ``max_batch`` maps to the number of concurrent decode slots; requests
    are admitted at decode-segment boundaries.
    """

    def __init__(self, engine: AsrEngine, max_batch: int = 8,
                 segment_steps: int = 8, max_new_tokens=None):
        batcher = ContinuousBatcher(
            engine,
            n_slots=max_batch,
            segment_steps=segment_steps,
            max_new_tokens=max_new_tokens,
        )
        super().__init__(batcher)
        self.engine = engine

    def submit(self, req: Request) -> None:
        self.batcher.submit(req)


# A copy of qwen3_asr_rs_tpu/runtime/server.py::_parse_multipart.
def _parse_multipart(content_type: str, body: bytes) -> dict:
    """multipart/form-data -> {field_name: bytes} via the stdlib email
    parser (binary-exact payloads: a hand-rolled splitter was measured
    to strip trailing 0x0A/0x0D bytes from uploaded audio)."""
    import email.parser
    import email.policy

    if "boundary=" not in content_type:
        raise ValueError("multipart/form-data with boundary required")
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
    )
    if not msg.is_multipart():
        raise ValueError("malformed multipart body")
    fields: dict = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            fields[name] = part.get_payload(decode=True)
    return fields


def make_handler(worker: BatchingWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok"})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/transcribe":
                self._transcribe(parsed)
            elif parsed.path == "/v1/audio/transcriptions":
                self._openai_transcriptions()
            else:
                self._json(404, {"error": "not found"})

        def _run(self, body, language, max_new=None, temperature=0.0,
                 top_p=1.0):
            """-> (result, audio_duration_seconds)."""
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(body)
                f.flush()
                samples = load_audio(f.name, 16000)
            req = Request(
                samples, language, max_new_tokens=max_new,
                temperature=temperature, top_p=top_p,
            )
            worker.submit(req)
            try:
                return req.wait(), len(samples) / 16000.0
            except ValueError:
                raise  # per-request validation (e.g. over-long prompt)
            except Exception as e:
                # the request was accepted; a failure here (serving loop
                # death, device fault) is the server's, not the client's
                raise _ServerFault(str(e)) from e

        def _transcribe(self, parsed):
            qs = parse_qs(parsed.query)
            language = qs.get("language", [None])[0]
            max_new = qs.get("max_new", [None])[0]
            temperature = qs.get("temperature", ["0"])[0]
            top_p = qs.get("top_p", ["1"])[0]
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                result, _ = self._run(
                    body, language, int(max_new) if max_new else None,
                    temperature=float(temperature),
                    top_p=float(top_p),
                )
                self._json(200, {
                    "language": result.language,
                    "text": result.text,
                })
            except _ServerFault as e:
                self._json(500, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(400, {"error": str(e)})

        def _openai_transcriptions(self):
            """OpenAI Whisper-API-compatible route (multipart form).

            Request-shape problems (bad multipart, missing file,
            undecodable audio) -> 400 invalid_request_error; failures
            AFTER the request was accepted (serving loop death) -> 500
            server_error, so clients retry transient faults.
            """
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                fields = _parse_multipart(
                    self.headers.get("Content-Type", ""), body
                )
                if "file" not in fields:
                    self._json(
                        400,
                        {"error": {"message": "missing 'file' field",
                                   "type": "invalid_request_error"}},
                    )
                    return
                language = fields.get("language")
                if isinstance(language, bytes):
                    language = language.decode()
                fmt = fields.get("response_format", b"json")
                if isinstance(fmt, bytes):
                    fmt = fmt.decode()
                temperature = fields.get("temperature", b"0")
                if isinstance(temperature, bytes):
                    temperature = temperature.decode()
                top_p = fields.get("top_p", b"1")
                if isinstance(top_p, bytes):
                    top_p = top_p.decode()
                result, duration = self._run(
                    fields["file"], language or None,
                    temperature=float(temperature or 0),
                    top_p=float(top_p or 1),
                )
                if fmt == "text":
                    data = (result.text + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif fmt == "verbose_json":
                    # Whisper-shaped segments: serving requests fit one
                    # bucket, so a single [0, duration] span unless the
                    # engine attached stitched long-form segments
                    from .longform import Segment, attach_words

                    segs = result.segments
                    if segs is None:
                        segs = []
                        if result.text.strip():
                            segs = attach_words(
                                [Segment(0, 0.0, duration, result.text)]
                            )
                    words = [
                        {"word": w.word, "start": w.start, "end": w.end}
                        for s in segs for w in (s.words or [])
                    ]
                    self._json(200, {
                        "task": "transcribe",
                        "language": result.language,
                        "duration": round(duration, 3),
                        "text": result.text,
                        # OpenAI emits the flat word list only under
                        # timestamp_granularities[]=word; emitting it
                        # unconditionally is a strict superset (clients
                        # that didn't ask simply ignore the key)
                        "words": words,
                        "segments": [
                            # the full Whisper verbose_json key set:
                            # strict clients index tokens/avg_logprob/...,
                            # so absent-but-documented is not enough.
                            # Neutral placeholders where this engine has
                            # no per-segment value (greedy decode exposes
                            # no logprobs; tokens are not retained per
                            # stitched span).
                            {"id": s.id, "seek": 0,
                             "start": round(s.start, 3),
                             "end": round(s.end, 3),
                             "text": s.text,
                             "tokens": [],
                             "temperature": 0.0,
                             "avg_logprob": 0.0,
                             "compression_ratio": 1.0,
                             "no_speech_prob": 0.0,
                             "words": [
                                 {"word": w.word, "start": w.start,
                                  "end": w.end}
                                 for w in (getattr(s, "words", None) or [])
                             ]}
                            for s in segs
                        ],
                    })
                else:
                    self._json(200, {"text": result.text})
            except _ServerFault as e:
                self._json(
                    500,
                    {"error": {"message": str(e),
                               "type": "server_error"}},
                )
            except Exception as e:  # noqa: BLE001
                self._json(
                    400,
                    {"error": {"message": str(e),
                               "type": "invalid_request_error"}},
                )

        def _json(self, code, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return Handler


def serve(engine: AsrEngine, host: str = "0.0.0.0", port: int = 8080,
          max_batch: int = 8):
    """Run the continuous-batching HTTP server (blocking).

    Every bucket's admission and every decode-segment variant runs first
    (on CUDA: captures every segment graph), so the first live request
    never pays for one. The batcher then runs on the calling thread and
    HTTP serves from a daemon thread.
    """
    worker = BatchingWorker(engine, max_batch)
    logger.info("warmup: every bucket's admission and segment variant")
    worker.batcher.warmup()
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    logger.info("serving on %s:%d", host, port)
    http_thread = threading.Thread(target=server.serve_forever, daemon=True)
    http_thread.start()
    try:
        worker.run()  # blocking batcher loop on this thread
    finally:
        server.shutdown()


def main(argv=None):
    """``python -m qwen3_asr_rs_tpu_torch.runtime.server <model> [port]``:
    an AsrEngine on ``ASR_DEVICE`` (default cuda, with no CPU fallback)
    in ``ASR_DTYPE`` (bf16, or float32), ``ASR_MAX_NEW_TOKENS`` and
    ``ASR_QUANT`` as the CLI reads them, behind the server."""
    import torch

    from ..cli import setup_logging

    setup_logging()
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m qwen3_asr_rs_tpu_torch.runtime.server "
              "<model_path> [port]", file=sys.stderr)
        return 1
    device = os.environ.get("ASR_DEVICE", "cuda")
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("Error: no CUDA device (set ASR_DEVICE=cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    dtype = (torch.float32
             if os.environ.get("ASR_DTYPE", "").lower() in ("float32", "f32")
             else torch.bfloat16)
    engine = AsrEngine(
        argv[0], dtype=dtype, device=device,
        max_new_tokens=int(os.environ.get("ASR_MAX_NEW_TOKENS", "4096")),
        quantize=os.environ.get("ASR_QUANT") or None)
    serve(engine, port=int(argv[1]) if len(argv) > 1 else 8080)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
