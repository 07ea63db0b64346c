"""The port's command-line interface (`aura_snn_rag_tpu_torch/cli.py`, on
argparse), on the CPU at the debug preset: the commands it lists,
`ingest` (as `tests/test_cli.py` holds the JAX CLI's), `train` writing a
checkpoint that `train` resumes and `generate` reads back, the stdlib
HTTP front end of `serve` in process on an ephemeral port (as
`tests/test_cli_serve.py` holds the JAX package's aiohttp app), and the
`serve` command itself in a subprocess."""

import asyncio
import dataclasses
import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch import cli
from aura_snn_rag_tpu_torch.generation.serving import BatchedGenerator
from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMMANDS = ("train", "generate", "ingest", "serve")


def test_help_lists_commands(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for cmd in COMMANDS:
        assert cmd in out
    for cmd in COMMANDS:
        with pytest.raises(SystemExit):
            cli.main([cmd, "--help"])
        assert "--device" in capsys.readouterr().out


def test_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "aura_snn_rag_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert all(cmd in out.stdout for cmd in COMMANDS)


def test_ingest_command(tmp_path, capsys):
    p = tmp_path / "rows.jsonl"
    p.write_text('{"text": "alpha"}\n{"text": "beta"}\n')
    assert cli.main(["ingest", str(p), "--feature-dim", "64",
                     "--device", "cpu"]) == 0
    assert "stored 2 memories" in capsys.readouterr().out
    hf, embedder, n = cli.ingest(str(p), feature_dim=64, device="cpu")
    assert n == hf.memory_count == 2 and embedder.dim == 64
    assert hf.host_state_dict()["slot_ids"][:2] == ["jsonl-0", "jsonl-1"]


def test_train_resume_and_generate(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    data = tmp_path / "tokens.npy"
    np.save(data, np.random.RandomState(0).randint(1, 500, (32, 32))
            .astype(np.int32))
    args = ["--preset", "debug", "--device", "cpu", "--checkpoint-dir", ck]
    assert cli.main(["train", "--steps", "3", "--data", str(data)]
                    + args) == 0
    assert "done" in capsys.readouterr().out
    assert CheckpointManager(ck).latest_step() == 3
    assert cli.main(["train", "--steps", "5", "--data", str(data)]
                    + args) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done" in out
    assert CheckpointManager(ck).all_steps() == [3, 5]
    assert cli.main(["train", "--steps", "4"] + args) == 0
    assert "nothing to train" in capsys.readouterr().out

    assert cli.main(["generate", "--prompt-ids", "1,2,3",
                     "--max-new-tokens", "4"] + args) == 0
    toks = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert toks[:3] == [1, 2, 3] and len(toks) == 7
    vocab = port.get_debug_config().model.vocab_size
    assert all(0 <= t < vocab for t in toks)
    # generate decodes the restored model: the same tokens again
    assert cli.generate(ck, "debug", "1,2,3", 4, device="cpu") == toks
    with pytest.raises(ValueError, match="prompt_ids"):
        cli.generate(ck, "debug", f"1,{vocab}", 4, device="cpu")


# --------------------------------------------------------------------------
# serve's HTTP front end
# --------------------------------------------------------------------------

async def request(port_, method, path, body=None):
    """(status, JSON body) of one raw HTTP/1.1 request."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port_)
    raw = body if isinstance(body, bytes) else (
        b"" if body is None else json.dumps(body).encode())
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
                 f"{len(raw)}\r\n\r\n".encode() + raw)
    await writer.drain()
    data = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


def test_http_round_trip():
    cfg = dataclasses.replace(port.get_debug_config().model, dropout=0.0)
    model = port.HippocampalTransformer(cfg, device="cpu").eval()
    gen = BatchedGenerator(model, batch_size=2, prompt_pad=8,
                           max_new_tokens=4)

    async def run():
        server = await cli.start_http(gen, cfg.vocab_size, "127.0.0.1", 0,
                                      max_new_tokens=4)
        p = server.sockets[0].getsockname()[1]
        task = asyncio.create_task(gen.serve_forever(flush_ms=10))
        try:
            ok = {"prompt_ids": [1, 2, 3], "max_new_tokens": 2,
                  "temperature": 0.5}
            status, data = await request(p, "POST", "/generate", ok)
            assert status == 200 and len(data["tokens"]) == 2
            status, stats = await request(p, "GET", "/stats")
            assert status == 200 and stats["requests"] == 1
            assert (await request(p, "GET", "/nope"))[0] == 404
            assert (await request(p, "GET", "/generate"))[0] == 405
            for bad in (b"{not json", b"[1, 2]", {"prompt_ids": []},
                        {"prompt_ids": [1, cfg.vocab_size]},
                        {"prompt_ids": [1], "max_new_tokens": 0},
                        {"prompt_ids": [1], "temperature": "hot"}):
                status, data = await request(p, "POST", "/generate", bad)
                assert status == 400 and "error" in data, bad
            # a request line that is not HTTP
            r, w = await asyncio.open_connection("127.0.0.1", p)
            w.write(b"garbage\r\n\r\n")
            await w.drain()
            assert (await r.read()).startswith(b"HTTP/1.1 400")
            w.close()
            # still serving
            status, data = await request(p, "POST", "/generate",
                                         dict(ok, max_new_tokens=3))
            assert status == 200 and len(data["tokens"]) == 3
            assert (await request(p, "GET", "/stats"))[1]["requests"] == 2
        finally:
            task.cancel()
            server.close()
            await server.wait_closed()

    asyncio.run(asyncio.wait_for(run(), timeout=120))


def test_serve_command_in_a_subprocess(tmp_path):
    ck = str(tmp_path / "ck")
    cli.train("debug", 2, None, ck, device="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aura_snn_rag_tpu_torch.cli", "serve",
         "--preset", "debug", "--device", "cpu", "--port", "0",
         "--checkpoint-dir", ck, "--max-new-tokens", "4"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (
            line, proc.poll())
        conn = http.client.HTTPConnection(
            "127.0.0.1", int(line.rsplit(":", 1)[1]), timeout=60)
        conn.request("POST", "/generate", json.dumps(
            {"prompt_ids": [4, 5], "max_new_tokens": 3}))
        r = conn.getresponse()
        assert r.status == 200 and len(json.loads(r.read())["tokens"]) == 3
        conn.close()
        conn.request("GET", "/stats")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["requests"] == 1
        conn.close()
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
