"""The port's HTTP server (``runtime/server.py``) on the CPU: the cases of
``tests/test_wer_and_server.py`` against the port's BatchingWorker, each
answer held against the same request submitted to a batcher directly
(and so against the JAX and port engines' offline output, float32)."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from qwen3_asr_rs_tpu.runtime.server import (
    _parse_multipart as jax_parse_multipart,
)
from qwen3_asr_rs_tpu_torch.runtime.server import (
    BatchingWorker,
    _parse_multipart,
    main,
    make_handler,
)
from qwen3_asr_rs_tpu_torch.runtime.prompt import parse_asr_output

from test_audio_io import write_wav_pcm16
from test_torch_serving import engines


@pytest.fixture(scope="module")
def pair():
    return engines(max_new=2)


@pytest.fixture(scope="module")
def server(pair):
    worker = BatchingWorker(pair.port, max_batch=4)
    worker.start()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    worker.stop()
    worker.join(timeout=30)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """(WAV bytes, the samples the server decodes from them)."""
    from qwen3_asr_rs_tpu_torch.audio.load import load_audio

    path = tmp_path_factory.mktemp("srv") / "a.wav"
    write_wav_pcm16(path, np.random.default_rng(3).standard_normal(16000)
                    * 0.1, 16000)
    return path.read_bytes(), load_audio(str(path), 16000)


def _expected_text(pair, samples) -> str:
    return parse_asr_output(pair.offline(samples), False)[1]


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz") as r:
        assert json.loads(r.read())["status"] == "ok"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope")
    assert e.value.code == 404


def test_transcribe_endpoint(server, wav, pair):
    req = urllib.request.Request(f"{server}/transcribe", data=wav[0],
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    assert set(out) == {"language", "text"}
    assert out["text"] == _expected_text(pair, wav[1])


def test_concurrent_requests(server, wav, pair):
    results = []

    def hit():
        req = urllib.request.Request(f"{server}/transcribe", data=wav[0],
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            results.append(json.loads(r.read()))

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert len(results) == 4
    # identical audio -> identical transcription regardless of batching
    assert {r["text"] for r in results} == {_expected_text(pair, wav[1])}


def _post_form(server, audio, fields):
    boundary = "testboundary42"
    parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="{name}"\r\n\r\n{val}\r\n'.encode()
             for name, val in fields.items()]
    if audio is not None:
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="file"; filename="a.wav"\r\n'
                     f"Content-Type: audio/wav\r\n\r\n".encode()
                     + audio + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    req = urllib.request.Request(
        f"{server}/v1/audio/transcriptions", data=b"".join(parts),
        method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    return urllib.request.urlopen(req, timeout=120)


def test_openai_transcriptions_endpoint(server, wav, pair):
    """The Whisper-API route: multipart upload, three formats, the nucleus
    extension field, and client errors as 400 invalid_request_error."""
    audio, samples = wav
    text = _expected_text(pair, samples)
    with _post_form(server, audio, {}) as r:
        assert json.loads(r.read()) == {"text": text}
    with _post_form(server, audio, {"response_format": "verbose_json"}) as r:
        out = json.loads(r.read())
    assert out["task"] == "transcribe" and out["text"] == text
    assert abs(out["duration"] - 1.0) < 0.01
    if text.strip():
        (seg,) = out["segments"]
        assert (seg["start"], seg["end"], seg["text"]) == (
            0.0, out["duration"], text)
        for key in ("tokens", "temperature", "avg_logprob",
                    "compression_ratio", "no_speech_prob", "seek"):
            assert key in seg, key
        assert out["words"] == [w for s in out["segments"]
                                for w in s["words"]]
        for w in out["words"]:
            assert set(w) == {"word", "start", "end"}
    with _post_form(server, audio, {"response_format": "text"}) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        assert r.read().decode() == text + "\n"
    # a tiny top_p at temperature > 0 keeps only the top-1 token: greedy
    with _post_form(server, audio, {"temperature": "2.0",
                                    "top_p": "0.000001"}) as r:
        assert json.loads(r.read())["text"] == text
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_form(server, audio, {"temperature": "0.5", "top_p": "1.5"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_form(server, None, {"language": "english"})
    assert e.value.code == 400
    assert json.loads(e.value.read())["error"]["type"] == (
        "invalid_request_error")


def test_parse_multipart_binary_exact():
    """File bytes ending in 0x0A/0x0D round-trip exactly, and the port's
    copy parses what the JAX server's parses."""
    payload = b"\x00\x01RIFF\x0a\x0d\x0a"
    boundary = "bx1"
    body = (
        f"--{boundary}\r\nContent-Disposition: form-data; "
        f'name="file"; filename="a.bin"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n".encode()
        + payload
        + f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
        f'name="language"\r\n\r\nenglish\r\n--{boundary}--\r\n'.encode()
    )
    ctype = f"multipart/form-data; boundary={boundary}"
    fields = _parse_multipart(ctype, body)
    assert fields == {"file": payload, "language": b"english"}
    assert fields == jax_parse_multipart(ctype, body)
    with pytest.raises(ValueError, match="boundary"):
        _parse_multipart("multipart/form-data", body)


def test_main_usage_and_no_cuda(capsys, monkeypatch, tmp_path):
    """No model path: usage, exit 1; the default device is CUDA with no
    CPU fallback: on a machine without one, exit 1 and say so."""
    assert main([]) == 1
    assert "Usage" in capsys.readouterr().err
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("ASR_DEVICE", raising=False)
    assert main([str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
