"""The port's HTTP server (serve_torch_cli.py) on the CPU: the real server
in a subprocess (tiny_test, random weights) answers /healthz, two
concurrent /tts in one micro-batch wave, Long TTS and /rerun, /edit with
alignment rows and with edit_spans, and /tts_stream, whose PCM has the
length of the same request's /tts output; in process, a stream cancelled by
its consumer still feeds the stream tier's autospec arm."""

import base64
import csv
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "demo"
PROMPT_TEXT = "the sound of birds over the river at dawn"
TIMEOUT = 120
# the micro-batch window: a /tts handler decodes and encodes its prompt
# (the codec on the CPU) before it queues its slot, 1.0 s idle and up to
# 2.1 s with the CPU shared among busy processes, so a window of twice the
# slowest lets two concurrent posts meet in one wave
WINDOW_MS = 4000
COMMON = {"top_k": 15, "silence_tokens": [5, 7]}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    port = _free_port()
    logf = tmp_path_factory.mktemp("serve") / "server.log"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    with open(logf, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "serve_torch_cli.py"),
             "--model", "tiny_test", "--random-init", "--device", "cpu",
             "--text-backend", "grapheme", "--port", str(port),
             "--batch-window-ms", str(WINDOW_MS)],
            stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        for _ in range(120):
            if proc.poll() is not None:
                raise RuntimeError(logf.read_text()[-2000:])
            try:
                urllib.request.urlopen(base + "/healthz", timeout=2)
                break
            except Exception:
                time.sleep(0.25)
        else:
            raise TimeoutError("server did not come up")
        yield types.SimpleNamespace(base=base, log=logf)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=10)
        finally:
            if proc.poll() is None:
                proc.kill()


def _post(base, path, payload):
    req = urllib.request.Request(base + path,
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _wav_b64(path=DEMO / "demo.wav"):
    return base64.b64encode(path.read_bytes()).decode()


def _samples(b64):
    with wave.open(io.BytesIO(base64.b64decode(b64))) as wf:
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), dtype="<i2")
    return pcm


def _alignment():
    with open(DEMO / "demo_alignment.csv") as f:
        return [{k: (float(v) if k in ("Begin", "End") else v)
                 for k, v in r.items()} for r in csv.DictReader(f)]


def test_healthz(server):
    with urllib.request.urlopen(server.base + "/healthz", timeout=10) as r:
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["n_codebooks"] == 4
    assert info["device"] == "cpu"


def test_concurrent_tts_ride_one_wave(server):
    b64, results = _wav_b64(), [None, None]
    gate = threading.Barrier(2)

    def run(i, text):
        payload = {"prompt_wav_b64": b64, "prompt_end_sec": 1.5,
                   "prompt_transcript": "the sound of",
                   "target_transcript": text, **COMMON}
        gate.wait(timeout=TIMEOUT)      # both posts leave together
        results[i] = _post(server.base, "/tts", payload)

    ths = [threading.Thread(target=run, args=(i, t))
           for i, t in enumerate(["hello world", "another request"])]
    [t.start() for t in ths]
    [t.join(timeout=TIMEOUT) for t in ths]
    for r in results:
        assert r is not None and r["gen_sec"] > 0
        assert len(_samples(r["wav_b64"])) == round(r["gen_sec"] * 16000)
    assert "micro-batch wave: 2 slot(s) [tts,tts]" in server.log.read_text()


def test_long_tts_and_rerun(server):
    r = _post(server.base, "/tts", {
        "prompt_wav_b64": _wav_b64(), "prompt_end_sec": 1.2,
        "prompt_transcript": "the sound",
        "target_transcript": "First thing. Second thing.",
        "mode": "Long TTS", **COMMON})
    assert r["sentences"] == ["0: First thing.", "1: Second thing."]
    assert r["session"] and r["gen_sec"] > 0
    assert "First thing." in r["inference_transcript"]
    rr = _post(server.base, "/rerun", {
        "session": r["session"], "sentence_idx": 1,
        "sentence_text": "A new second thing.", "seed": 7})
    whole, one = _samples(rr["wav_b64"]), _samples(rr["sentence_wav_b64"])
    assert 0 < len(one) < len(whole) and len(whole) % 320 == 0


def test_edit_with_alignment_rows_and_spans(server):
    b64 = _wav_b64()
    r = _post(server.base, "/edit", {
        "wav_b64": b64, "orig_transcript": PROMPT_TEXT,
        "target_transcript": "the sound of waves over the river at dawn",
        "edit_type": "substitution", "alignment": _alignment(), **COMMON})
    s, e = r["edit_interval_frames"]
    assert 0 < s < e <= 216 and len(_samples(r["wav_b64"])) > 0
    r = _post(server.base, "/edit", {
        "wav_b64": b64, "target_transcript": "a very different phrase",
        "edit_spans": [[0.3, 0.6], [1.2, 1.5]], **COMMON})
    ivs = r["edit_interval_frames"]
    assert len(ivs) == 2 and ivs[0][1] <= ivs[1][0]
    assert len(_samples(r["wav_b64"])) % 320 == 0


def test_tts_stream_length_equals_tts(server):
    """/tts_stream: a WAV header, then PCM16 of the length, and within one
    PCM16 step of the samples, of the same greedy request's /tts output
    (the engine's greedy decode equals the single stream's)."""
    req = {"prompt_wav_b64": _wav_b64(), "prompt_end_sec": 1.5,
           "prompt_transcript": "the sound of",
           "target_transcript": "streamed hello", "burst": 16,
           "temperature": 0.0, **COMMON}
    http = urllib.request.Request(server.base + "/tts_stream",
                                  data=json.dumps(req).encode(),
                                  method="POST")
    reads = []
    with urllib.request.urlopen(http, timeout=TIMEOUT) as r:
        assert r.headers.get("Content-Type") == "audio/wav"
        while True:
            blk = r.read(65536)
            if not blk:
                break
            reads.append(blk)
    data = b"".join(reads)
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    pcm = np.frombuffer(data[44:], dtype="<i2")
    ref = _post(server.base, "/tts", req)
    assert pcm.size == round(ref["gen_sec"] * 16000) > 0
    # the streamed and one-shot decodes agree within ~1e-5, which can flip
    # a PCM16 rounding (one step of 1/32767)
    diff = np.abs(pcm.astype(np.int32) - _samples(ref["wav_b64"]))
    assert diff.max() <= 1


def test_server_refusals(capsys):
    import serve_torch_cli
    for flags, message in ((["--mesh", "2x1"], "--mesh 2x1 needs 2 processes"),
                           (["--spec", "fast"], "--spec takes an integer")):
        with pytest.raises(SystemExit):
            serve_torch_cli.main(["--model", "tiny_test", "--random-init",
                                  "--device", "cpu", *flags])
        assert message in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            serve_torch_cli.main(["--model", "tiny_test", "--random-init"])
        assert "no CUDA device is available" in capsys.readouterr().err


def test_cancelled_stream_feeds_the_autospec_arm():
    """In process, --spec auto with 3 MTP head groups: a /tts_stream whose
    consumer stops after its first audio still gives the stream tier's arm
    one sample (its frames and producer seconds so far)."""
    import serve_torch_cli
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = serve_torch_cli.build_parser().parse_args([
            "--model", "tiny_test_mtp", "--random-init", "--device", "cpu",
            "--text-backend", "grapheme", "--spec", "auto"])
        eng = serve_torch_cli.Engine(args)
        assert eng.autospec_stream.arms == [0, 4]
        gen = eng.tts_stream({
            "prompt_wav_b64": _wav_b64(), "prompt_end_sec": 1.5,
            "prompt_transcript": "the sound of", "burst": 16,
            "target_transcript": "a long streamed sentence to cancel",
            **COMMON})
        assert next(gen)[:4] == b"RIFF"
        assert len(next(gen)) > 0           # the first audio
        gen.close()
        arms = eng.autospec_stream.snapshot()["arms"]
        assert sum(a["n"] for a in arms.values()) == 1
        assert arms["4"]["n"] == 1 and arms["4"]["fps"] > 0
        assert not eng.lock.locked()
    finally:
        torch.set_num_threads(n)
