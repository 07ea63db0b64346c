"""Command-line interface of the port (counterpart of
`aura_snn_rag_tpu/cli.py`, which is built on click, orbax and aiohttp;
this one needs argparse and asyncio alone):

    python -m aura_snn_rag_tpu_torch.cli train [--preset P] [--steps N]
        [--data tokens.npy] [--checkpoint-dir D] [--seed S]
    python -m aura_snn_rag_tpu_torch.cli generate [--checkpoint-dir D]
        [--preset P] [--prompt-ids 1,2,3] [--max-new-tokens N]
        [--temperature T] [--top-k K] [--top-p P]
    python -m aura_snn_rag_tpu_torch.cli ingest PATH [--format jsonl|csv]
        [--max-items N] [--feature-dim D]
    python -m aura_snn_rag_tpu_torch.cli serve [--host H] [--port P]
        [--preset P] [--checkpoint-dir D] [--batch-size B]
        [--max-new-tokens N] [--bf16-weights]
    python -m aura_snn_rag_tpu_torch.cli brain-demo [TEXT]
    python -m aura_snn_rag_tpu_torch.cli corpus [--out D] [--vocab V]
    python -m aura_snn_rag_tpu_torch.cli mnist [--epochs N] [--hidden H]
        [--data mnist.npz]
    python -m aura_snn_rag_tpu_torch.cli bench [--small] [--sharded=N]

Every command but `corpus` takes `--device` (default cuda; raises
without a card); every command is also a function of the same name and
values. `serve`'s HTTP front end
(`start_http`, on `asyncio.start_server`, one request per connection):
`POST /generate` with a JSON body {"prompt_ids", "max_new_tokens",
"temperature", "top_p"} answers {"tokens": [...]}, `GET /stats` the
batched server's stats; another path answers 404, another method 405, a
malformed request 400 and a failed generation 500, and the server goes
on serving.

Where this CLI differs from the JAX package's: `generate` and `serve`
condition on the checkpoint's bank when the model has RAG and the bank
holds memories (the JAX CLI decodes without memory); `train` labels a
checkpoint with the number of steps taken (the JAX CLI labels a
periodic one a step early) and saves nothing when no step is left to
take; `serve` pads prompts to min(64, max_seq_len - max_new_tokens)
tokens (the JAX CLI to 64, which a short-context preset cannot decode).
`brain-demo` routes a text through a `NeuromorphicBrainSystem(d_model=32,
n_neurons=32)` and prints the JAX CLI's three lines: the plan, the
output's mean absolute value and the recommendations. `corpus` runs
`tools/build_offline_corpus.py` (numpy and `tokenizers`, no JAX) in a
subprocess with the JAX CLI's options: `--out` is passed on only when
given, so the tool's own default applies. `mnist` runs the port's
`bench_mnist` (whitener -> Oja -> readout) in this process, on the
device; its data is `--data` (an MNIST .npz) or keras's cached
`mnist.npz`, else sklearn's bundled digits. `bench` runs the port's
retrieval benchmark (`bench.main`, the counterpart of the root
`bench.py`) in this process at its defaults (1M x 768 on the device) or
`--small`, and prints its JSON line (`--sharded=N`: the sharded-scaling
check's, on N ranks of `--device`, gloo ranks on the host with `--device
cpu`); a failed run raises, so the command exits non-zero.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import functools
import json
import logging
import math
import os
import subprocess
import sys
from http import HTTPStatus
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

PRESETS = ("debug", "test", "small", "medium", "full")
MAX_BODY = 1 << 20           # bytes of a request body


def _config(preset: str):
    from aura_snn_rag_tpu_torch import config as cfg_mod
    if preset not in PRESETS:
        raise ValueError(f"preset {preset!r}, expected one of {PRESETS}")
    return getattr(cfg_mod, f"get_{preset}_config")()


def _bank(trainer):
    """The trainer's bank when its model retrieves and the bank holds
    memories, else None."""
    if trainer.config.model.use_rag and trainer.hippocampus.memory_count:
        return trainer.hippocampus.state
    return None


# ----------------------------------------------------------------------
# train / generate / ingest
# ----------------------------------------------------------------------

def train(preset: str = "test", steps: Optional[int] = None,
          data: Optional[str] = None, checkpoint_dir: str = "checkpoints",
          seed: int = 42, device: str = "cuda"):
    """Train the hippocampal transformer, resuming from the newest
    checkpoint in `checkpoint_dir`; returns the trainer."""
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
    from aura_snn_rag_tpu_torch.training.data import (
        batch_iterator, load_or_synthesize)
    from aura_snn_rag_tpu_torch.training.trainer import Trainer

    cfg = _config(preset)
    if steps:
        cfg = cfg.replace(training=dataclasses.replace(
            cfg.training, max_steps=steps))
    tcfg = cfg.training
    trainer = Trainer(cfg, seed=seed, device=device)
    ckpt = CheckpointManager(checkpoint_dir)
    start = ckpt.restore(trainer)
    if start:
        print(f"resumed from step {start}")
    if start >= tcfg.max_steps:
        print(f"nothing to train: step {start} of {tcfg.max_steps}")
        return trainer
    it = batch_iterator(load_or_synthesize(data, cfg.model, seed),
                        tcfg.batch_size, seed)
    for step in range(start, tcfg.max_steps):
        ids = next(it)
        metrics = trainer.train_step(ids, ids)
        if step % tcfg.logging_steps == 0:
            ppl = math.exp(min(metrics["ce"], 20))
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"ppl={ppl:.1f} mem={metrics['use_memory']}", flush=True)
        if (step + 1) % tcfg.save_steps == 0 and step + 1 < tcfg.max_steps:
            ckpt.save(step + 1, trainer, trainer.latest_metrics()["loss"])
    ckpt.save(tcfg.max_steps, trainer, trainer.latest_metrics()["loss"])
    print("done")
    return trainer


def _prompt_ids(ids: Sequence[Any], vocab_size: int) -> List[int]:
    """Token ids from outside, checked: an id outside the vocabulary
    would index past the embedding on the device."""
    if not ids or not all(isinstance(t, int) and not isinstance(t, bool)
                          and 0 <= t < vocab_size for t in ids):
        raise ValueError(f"prompt_ids must be a non-empty list of token "
                         f"ids in [0, {vocab_size})")
    return list(ids)


def generate(checkpoint_dir: str = "checkpoints", preset: str = "test",
             prompt_ids: str = "1,2,3", max_new_tokens: int = 32,
             temperature: float = 0.8, top_k: int = 50, top_p: float = 0.9,
             device: str = "cuda") -> List[int]:
    """Tokens (prompt and new) from the newest checkpoint's model by
    KV-cached decode."""
    import torch
    from aura_snn_rag_tpu_torch.generation.sampler import generate as gen
    from aura_snn_rag_tpu_torch.training.checkpoint import CheckpointManager
    from aura_snn_rag_tpu_torch.training.trainer import Trainer

    cfg = _config(preset)
    ids = _prompt_ids([int(x) for x in prompt_ids.split(",")],
                      cfg.model.vocab_size)
    trainer = Trainer(cfg, device=device)
    CheckpointManager(checkpoint_dir).restore(trainer)
    memory = _bank(trainer)
    out = gen(trainer.model, torch.tensor([ids]), max_new_tokens,
              torch.Generator(device=trainer.device).manual_seed(0),
              temperature=temperature, top_k=top_k, top_p=top_p,
              memory_state=memory, use_memory=memory is not None)
    return out[0].tolist()


def ingest(path: str, fmt: str = "jsonl", max_items: Optional[int] = None,
           feature_dim: int = 768, device: str = "cuda"):
    """Ingest a JSONL or CSV corpus into a new episodic bank of
    `MemoryConfig(feature_dim=feature_dim)` through the hash embedder;
    returns (bank, embedder, number stored)."""
    from aura_snn_rag_tpu_torch.config import MemoryConfig
    from aura_snn_rag_tpu_torch.encoders import FastHashEmbedder
    from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation
    from aura_snn_rag_tpu_torch.services.ingest import (
        ingest_csv_pairs_to_memory, ingest_jsonl_to_memory)

    fn = {"jsonl": ingest_jsonl_to_memory,
          "csv": ingest_csv_pairs_to_memory}[fmt]
    hf = HippocampalFormation(MemoryConfig(feature_dim=feature_dim),
                              device=device)
    embedder = FastHashEmbedder(dim=feature_dim)
    n = fn(hf, path, embedder.embed_batch, max_items=max_items)
    return hf, embedder, n


# ----------------------------------------------------------------------
# serve: the batched generator behind a stdlib HTTP front end
# ----------------------------------------------------------------------

class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _number(body: Dict[str, Any], key: str, default: float) -> float:
    x = body.get(key, default)
    if isinstance(x, bool) or not isinstance(x, (int, float)) \
            or not math.isfinite(x):
        raise HTTPError(400, f"{key} must be a finite number")
    return float(x)


def _generate_request(raw: bytes, vocab_size: int, max_new_tokens: int
                      ) -> Tuple[List[int], int, float, float]:
    try:
        body = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise HTTPError(400, f"body is not JSON: {e}")
    if not isinstance(body, dict):
        raise HTTPError(400, "body must be a JSON object")
    try:
        ids = _prompt_ids(body.get("prompt_ids"), vocab_size)
    except (ValueError, TypeError) as e:
        raise HTTPError(400, str(e))
    n = body.get("max_new_tokens", max_new_tokens)
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise HTTPError(400, "max_new_tokens must be a positive integer")
    return (ids, n, _number(body, "temperature", 0.8),
            _number(body, "top_p", 0.9))


async def _read_request(reader: asyncio.StreamReader
                        ) -> Tuple[str, str, bytes]:
    """(method, path, body) of one HTTP/1.1 request; the body is read by
    its Content-Length."""
    try:
        method, target, _ = (await reader.readline()).decode(
            "latin-1").split()
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, sep, value = line.decode("latin-1").partition(":")
            if not sep:
                raise ValueError("header without a colon")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0"))
    except ValueError as e:         # also a line over the reader's limit
        raise HTTPError(400, f"malformed request: {e}")
    if not 0 <= length <= MAX_BODY:
        raise HTTPError(413, f"body of {length} bytes")
    return method, target.split("?", 1)[0], await reader.readexactly(length)


async def _route(gen, vocab_size: int, max_new_tokens: int,
                 reader: asyncio.StreamReader) -> Tuple[int, Any]:
    method, path, raw = await _read_request(reader)
    routes = {"/generate": "POST", "/stats": "GET"}
    if path not in routes:
        raise HTTPError(404, f"no route {path}")
    if method != routes[path]:
        raise HTTPError(405, f"{method} {path}")
    if path == "/stats":
        return 200, gen.stats
    ids, n, temperature, top_p = _generate_request(raw, vocab_size,
                                                   max_new_tokens)
    try:
        toks = await gen.submit(ids, max_new_tokens=n,
                                temperature=temperature, top_p=top_p)
    except Exception as e:      # noqa: BLE001 - the server stays up
        logger.exception("generation failed")
        raise HTTPError(500, f"generation failed: {e}")
    return 200, {"tokens": [int(t) for t in toks]}


async def _handle(gen, vocab_size: int, max_new_tokens: int,
                  reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter) -> None:
    try:
        try:
            status, body = await _route(gen, vocab_size, max_new_tokens,
                                        reader)
        except HTTPError as e:
            status, body = e.status, {"error": str(e)}
        payload = json.dumps(body).encode()
        writer.write(
            f"HTTP/1.1 {status} {HTTPStatus(status).phrase}\r\n"
            f"Content-Type: application/json; charset=utf-8\r\n"
            f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
            .encode() + payload)
        await writer.drain()
    except (ConnectionError, asyncio.IncompleteReadError):
        pass                        # the client went away
    finally:
        writer.close()
        with contextlib.suppress(ConnectionError):
            await writer.wait_closed()


async def start_http(gen, vocab_size: int, host: str = "127.0.0.1",
                     port: int = 8787, max_new_tokens: int = 64
                     ) -> asyncio.Server:
    """The HTTP front end over `gen` (a `BatchedGenerator`, whose
    `serve_forever` must run beside it), listening on host:port (port 0
    takes a free one)."""
    return await asyncio.start_server(
        functools.partial(_handle, gen, vocab_size, max_new_tokens),
        host, port)


def serve(host: str = "127.0.0.1", port: int = 8787, preset: str = "test",
          checkpoint_dir: Optional[str] = None, batch_size: int = 8,
          max_new_tokens: int = 64, bf16_weights: bool = False,
          device: str = "cuda") -> None:
    """Serve generation over HTTP until the process is stopped: the model
    of the newest checkpoint in `checkpoint_dir` (with its bank), or a
    new one from seed 0 without one."""
    import torch
    from aura_snn_rag_tpu_torch.generation.serving import BatchedGenerator
    from aura_snn_rag_tpu_torch.models.transformer import (
        HippocampalTransformer)

    cfg = _config(preset)
    memory = None
    if checkpoint_dir:
        from aura_snn_rag_tpu_torch.training.checkpoint import (
            CheckpointManager)
        from aura_snn_rag_tpu_torch.training.trainer import Trainer
        trainer = Trainer(cfg, seed=0, device=device)
        CheckpointManager(checkpoint_dir).restore(trainer)
        model, memory = trainer.model, _bank(trainer)
    else:
        dev = torch.device(device)
        model = HippocampalTransformer(
            cfg.model, cfg.memory if cfg.model.use_rag else None,
            device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model.eval()
    prompt_pad = min(64, cfg.model.max_seq_len - max_new_tokens)
    if prompt_pad < 1:
        raise ValueError(f"max_new_tokens {max_new_tokens} leaves no room "
                         f"for a prompt in {cfg.model.max_seq_len} tokens")
    gen = BatchedGenerator(
        model, batch_size=batch_size, prompt_pad=prompt_pad,
        max_new_tokens=max_new_tokens, memory_state=memory,
        weights_dtype="bfloat16" if bf16_weights else None)

    async def run():
        server = await start_http(gen, cfg.model.vocab_size, host, port,
                                  max_new_tokens)
        bound = server.sockets[0].getsockname()[1]
        print(f"serving on http://{host}:{bound}", flush=True)
        async with server:
            await asyncio.gather(server.serve_forever(), gen.serve_forever())

    asyncio.run(run())


# ----------------------------------------------------------------------
# brain-demo
# ----------------------------------------------------------------------

def brain_demo(text: str = "remember to analyze this pattern",
               device: str = "cuda") -> List[str]:
    """Route `text` through the neuromorphic brain system; returns the
    lines it prints."""
    from aura_snn_rag_tpu_torch.services.brain_system import (
        NeuromorphicBrainSystem)
    system = NeuromorphicBrainSystem(d_model=32, n_neurons=32, device=device)
    out, info = system.process_text(text)
    lines = [
        f"plan: {[(z, round(float(w), 3)) for z, w in info['plan']]}",
        f"output norm: {float(out.abs().mean()):.4f}",
        json.dumps(system.get_health()["recommendations"])]
    for line in lines:
        print(line)
    return lines


def corpus(out: Optional[str] = None, vocab: int = 32_000
           ) -> subprocess.CompletedProcess:
    """Build the offline training corpus (files on disk -> byte-level
    BPE -> uint16 token streams) with `tools/build_offline_corpus.py` in
    a subprocess; raises if it fails."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = [sys.executable,
            os.path.join(repo, "tools", "build_offline_corpus.py")]
    if out is not None:
        args += ["--out", out]
    return subprocess.run(args + ["--vocab", str(vocab)], check=True)


def bench(small: bool = False, device: str = "cuda",
          sharded: Optional[int] = None) -> Dict[str, Any]:
    """The retrieval benchmark (`bench.main`), which prints its JSON
    line; returns its object. `sharded` runs the sharded-scaling check on
    that many ranks of `device` instead."""
    from aura_snn_rag_tpu_torch import bench as bench_mod
    return bench_mod.main((["--small"] if small else [])
                          + ["--device", device]
                          + ([f"--sharded={sharded}"] if sharded is not None
                             else []))


def mnist(epochs: int = 5, hidden: int = 1024, data: Optional[str] = None,
          device: str = "cuda") -> Dict[str, Any]:
    """The hybrid whitener -> Oja -> readout benchmark
    (`bench_mnist.run`); returns its result."""
    from aura_snn_rag_tpu_torch import bench_mnist
    return bench_mnist.run(epochs=epochs, hidden=hidden, device=device,
                           data=data)


# ----------------------------------------------------------------------
# argument parsing
# ----------------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m aura_snn_rag_tpu_torch.cli",
        description="aura-snn-rag on PyTorch/CUDA: train, generate, "
                    "ingest, serve, brain-demo, corpus, mnist, bench.")
    sub = p.add_subparsers(dest="command", required=True)

    def command(name, help_text):
        c = sub.add_parser(name, help=help_text, description=help_text)
        c.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu to run on "
                            "the host)")
        return c

    c = command("train", "Train the hippocampal transformer.")
    c.add_argument("--preset", default="test", choices=PRESETS)
    c.add_argument("--steps", type=int, default=None,
                   help="override max training steps")
    c.add_argument("--data", default=None,
                   help="pre-tokenized .npy [n_seq, seq_len] token file")
    c.add_argument("--checkpoint-dir", default="checkpoints")
    c.add_argument("--seed", type=int, default=42)

    c = command("generate",
                "Generate tokens from a checkpoint (KV-cached decode).")
    c.add_argument("--checkpoint-dir", default="checkpoints")
    c.add_argument("--preset", default="test", choices=PRESETS)
    c.add_argument("--prompt-ids", default="1,2,3",
                   help="comma-separated token ids")
    c.add_argument("--max-new-tokens", type=int, default=32)
    c.add_argument("--temperature", type=float, default=0.8)
    c.add_argument("--top-k", type=int, default=50)
    c.add_argument("--top-p", type=float, default=0.9)

    c = command("ingest",
                "Ingest a JSONL/CSV corpus into an episodic memory bank.")
    c.add_argument("path")
    c.add_argument("--format", dest="fmt", default="jsonl",
                   choices=("jsonl", "csv"))
    c.add_argument("--max-items", type=int, default=None)
    c.add_argument("--feature-dim", type=int, default=768)

    c = command("serve", "HTTP generation server over the batched "
                         "KV-cached decoder.")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, default=8787)
    c.add_argument("--preset", default="test", choices=PRESETS)
    c.add_argument("--checkpoint-dir", default=None)
    c.add_argument("--batch-size", type=int, default=8)
    c.add_argument("--max-new-tokens", type=int, default=64)
    c.add_argument("--bf16-weights", action="store_true",
                   help="serve a bf16 copy of the f32 weights")

    c = command("brain-demo",
                "Route a text through the neuromorphic brain system.")
    c.add_argument("text", nargs="?", default="remember to analyze this "
                                              "pattern")

    c = sub.add_parser("corpus", help="Build the offline training corpus "
                                      "(tools/build_offline_corpus.py).")
    c.add_argument("--out", default=None,
                   help="output directory (default: the tool's)")
    c.add_argument("--vocab", type=int, default=32_000)

    c = command("mnist", "The hybrid whitener -> Oja -> readout "
                         "benchmark.")
    c.add_argument("--epochs", type=int, default=5)
    c.add_argument("--hidden", type=int, default=1024)
    c.add_argument("--data", default=None,
                   help="an MNIST .npz (x_train, y_train, x_test, y_test)")

    c = command("bench", "Run the retrieval benchmark (one JSON line).")
    c.add_argument("--small", action="store_true",
                   help="100,000 rows, K = 1024, probe 32, 8 batches of 32")
    c.add_argument("--sharded", type=int, default=None,
                   help="run the sharded-scaling check on N ranks "
                        "instead (one per card; gloo ranks on the host "
                        "with --device cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = vars(parser().parse_args(argv))
    command = args.pop("command")
    if command == "train":
        train(**args)
    elif command == "generate":
        print(json.dumps(generate(**args)))
    elif command == "ingest":
        hf, _, n = ingest(**args)
        print(f"stored {n} memories (bank count {hf.memory_count})")
    elif command == "brain-demo":
        brain_demo(**args)
    elif command == "corpus":
        corpus(**args)
    elif command == "mnist":
        print(json.dumps(mnist(**args)), flush=True)
    elif command == "bench":
        bench(**args)
    else:
        serve(**args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
