"""Continuous-learning orchestrator: streaming ingestion into episodic
memory (counterpart of `aura_snn_rag_tpu/services/continuous_learning.py`).

- asyncio loops: RSS/Atom feed fetch (only when `aiohttp` imports, and
  it is imported there, lazily), a watcher of `vocab_dir`'s *.txt files
  by mtime, the queue consumer;
- per batch of up to `batch_size` items: embed (`embed_fn`, else the
  hash embedder), the STDP salience update of the hashed tokens on the
  bank's device, then one `write_batch` into the hippocampus, or
  `zone_executor(features, category)` per item when `memory_only` is
  False and an executor is given;
- sha256 content dedup, JSON config save / load, a stats dict.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from aura_snn_rag_tpu_torch.encoders.hash_embedder import FastHashEmbedder
from aura_snn_rag_tpu_torch.memory.hippocampus import HippocampalFormation
from aura_snn_rag_tpu_torch.training.online import (
    STDPState, init_stdp, stdp_process_sequence)

logger = logging.getLogger(__name__)


@dataclass
class FeedConfig:
    url: str
    category: str = "general"
    interval_s: float = 1800.0
    last_fetch: float = 0.0


def create_default_feeds() -> List[FeedConfig]:
    """The default feed set: technology, science and news."""
    return [
        FeedConfig("https://hnrss.org/frontpage", "technology"),
        FeedConfig("https://feeds.arstechnica.com/arstechnica/science",
                   "science"),
        FeedConfig("https://feeds.bbci.co.uk/news/world/rss.xml", "news"),
    ]


def parse_feed_entries(body: str, max_entries: int = 20) -> List[str]:
    """Minimal RSS/Atom entry parser (stdlib only; feedparser optional).

    Returns "title summary" strings per entry. Uses feedparser when
    available, else xml.etree over <item>/<entry> elements.
    """
    try:
        import feedparser
        parsed = feedparser.parse(body)
        out = []
        for entry in parsed.entries[:max_entries]:
            text = " ".join(filter(None, [entry.get("title", ""),
                                          entry.get("summary", "")]))
            if text:
                out.append(text)
        return out
    except ImportError:
        pass

    import re
    import xml.etree.ElementTree as ET
    try:
        # strip namespaces so RSS and Atom parse uniformly
        cleaned = re.sub(r'xmlns(:\w+)?="[^"]*"', "", body, count=10)
        root = ET.fromstring(cleaned)
    except ET.ParseError:
        return []
    out = []
    for tag in ("item", "entry"):
        for el in root.iter(tag):
            title = el.findtext("title") or ""
            summary = (el.findtext("description")
                       or el.findtext("summary") or "")
            text = " ".join(filter(None, [title.strip(),
                                          re.sub(r"<[^>]+>", " ",
                                                 summary).strip()]))
            if text:
                out.append(text)
            if len(out) >= max_entries:
                return out
    return out


@dataclass
class IngestItem:
    text: str
    category: str = "general"
    source: str = "manual"
    memory_id: Optional[str] = None


class ContinuousLearningOrchestrator:
    """Feeds + directory watcher + queue → batched episodic writes."""

    def __init__(self,
                 hippocampus: HippocampalFormation,
                 embed_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
                 vocab_dir: Optional[str] = None,
                 feeds: Optional[List[FeedConfig]] = None,
                 memory_only: bool = True,
                 batch_size: int = 16,
                 vocab_size: int = 32000,
                 zone_executor: Optional[Callable[[np.ndarray, str], Any]] = None):
        self.hippocampus = hippocampus
        self.embed_fn = embed_fn
        self.hash_embedder = FastHashEmbedder(
            dim=hippocampus.config.feature_dim, token_vocab=vocab_size)
        self.vocab_dir = vocab_dir
        self.feeds = feeds or []
        self.memory_only = memory_only
        self.batch_size = batch_size
        self.zone_executor = zone_executor

        self.stdp_state: STDPState = init_stdp(vocab_size,
                                               device=hippocampus.device)
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=1000)
        self._seen_hashes: set = set()
        self._file_mtimes: Dict[str, float] = {}
        self._running = False
        self._tasks: List[asyncio.Task] = []
        self.stats = {"items_processed": 0, "memories_stored": 0,
                      "errors": 0, "duplicates_skipped": 0,
                      "feeds_fetched": 0}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> None:
        self._running = True
        self._tasks = [asyncio.create_task(self._loop_process_queue())]
        if self.feeds:
            self._tasks.append(asyncio.create_task(self._loop_feeds()))
        if self.vocab_dir:
            self._tasks.append(asyncio.create_task(self._loop_vocab_dir()))

    async def stop(self) -> None:
        self._running = False
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    # ------------------------------------------------------------------
    # producers
    # ------------------------------------------------------------------
    def _dedup(self, text: str) -> bool:
        h = hashlib.sha256(text.encode("utf-8", "ignore")).hexdigest()
        if h in self._seen_hashes:
            self.stats["duplicates_skipped"] += 1
            return True
        self._seen_hashes.add(h)
        return False

    async def submit(self, text: str, category: str = "general",
                     source: str = "manual",
                     memory_id: Optional[str] = None) -> bool:
        if self._dedup(text):
            return False
        await self.queue.put(IngestItem(text, category, source, memory_id))
        return True

    async def _loop_feeds(self) -> None:
        try:
            import aiohttp
        except ImportError:
            logger.warning("aiohttp unavailable — RSS disabled")
            return
        while self._running:
            now = time.time()
            async with aiohttp.ClientSession() as session:
                for feed in self.feeds:
                    if now - feed.last_fetch < feed.interval_s:
                        continue
                    try:
                        async with session.get(feed.url, timeout=30) as r:
                            body = await r.text()
                        for text in parse_feed_entries(body):
                            await self.submit(text, feed.category,
                                              source=feed.url)
                        feed.last_fetch = now
                        self.stats["feeds_fetched"] += 1
                    except Exception as e:  # noqa: BLE001
                        logger.warning("feed %s failed: %s", feed.url, e)
                        self.stats["errors"] += 1
            await asyncio.sleep(60)

    async def _loop_vocab_dir(self) -> None:
        while self._running:
            try:
                names = sorted(os.listdir(self.vocab_dir))
            except OSError:
                names = []
            count = 0
            for name in names:
                if not name.endswith(".txt") or count >= 50:
                    continue
                path = os.path.join(self.vocab_dir, name)
                try:
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue
                if self._file_mtimes.get(path) == mtime:
                    continue
                self._file_mtimes[path] = mtime
                try:
                    with open(path, encoding="utf-8", errors="ignore") as f:
                        text = f.read().strip()
                    if text:
                        await self.submit(text, "vocab", source=path)
                        count += 1
                except OSError as e:
                    logger.warning("vocab file %s failed: %s", path, e)
                    self.stats["errors"] += 1
            await asyncio.sleep(5)

    # ------------------------------------------------------------------
    # consumer: batched encode → STDP → episodic write
    # ------------------------------------------------------------------
    async def _loop_process_queue(self) -> None:
        while self._running:
            batch: List[IngestItem] = []
            try:
                item = await asyncio.wait_for(self.queue.get(), timeout=1.0)
                batch.append(item)
            except asyncio.TimeoutError:
                continue
            while len(batch) < self.batch_size:
                try:
                    batch.append(self.queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                self.process_batch(batch)
            except Exception as e:  # noqa: BLE001
                logger.exception("batch processing failed: %s", e)
                self.stats["errors"] += 1

    def process_batch(self, batch: List[IngestItem]) -> None:
        """Synchronous batched ingestion (also the test entry point)."""
        texts = [it.text for it in batch]
        if self.embed_fn is not None:
            feats = np.asarray(self.embed_fn(texts), np.float32)
        else:
            feats = self.hash_embedder.embed_batch(texts)

        # STDP token-salience update (padded batch)
        tok_lists = [self.hash_embedder.token_indices(t)[:128]
                     for t in texts]
        maxlen = max((len(t) for t in tok_lists), default=0)
        if maxlen > 0:
            toks = np.zeros((len(batch), maxlen), np.int32)
            for i, t in enumerate(tok_lists):
                toks[i, :len(t)] = t
            self.stdp_state, _ = stdp_process_sequence(
                self.stdp_state, torch.from_numpy(toks))

        if self.memory_only or self.zone_executor is None:
            ids = [it.memory_id or
                   f"cl-{hashlib.sha256(it.text.encode()).hexdigest()[:12]}"
                   for it in batch]
            self.hippocampus.write_batch(ids, feats)
            self.stats["memories_stored"] += len(batch)
        else:
            for it, f in zip(batch, feats):
                self.zone_executor(f, it.category)
        self.stats["items_processed"] += len(batch)

    # ------------------------------------------------------------------
    # one-shot helpers
    # ------------------------------------------------------------------
    def one_shot_memorize_text(self, text: str,
                               memory_id: Optional[str] = None) -> str:
        mid = memory_id or \
            f"oneshot-{hashlib.sha256(text.encode()).hexdigest()[:12]}"
        self.process_batch([IngestItem(text, memory_id=mid)])
        return mid

    # ------------------------------------------------------------------
    # config persistence
    # ------------------------------------------------------------------
    def save_config(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "feeds": [{"url": x.url, "category": x.category,
                           "interval_s": x.interval_s} for x in self.feeds],
                "vocab_dir": self.vocab_dir,
                "memory_only": self.memory_only,
                "batch_size": self.batch_size,
            }, f, indent=2)

    @classmethod
    def load_config(cls, path: str, hippocampus: HippocampalFormation,
                    **kw) -> "ContinuousLearningOrchestrator":
        with open(path) as f:
            data = json.load(f)
        feeds = [FeedConfig(**x) for x in data.get("feeds", [])]
        return cls(hippocampus, feeds=feeds,
                   vocab_dir=data.get("vocab_dir"),
                   memory_only=data.get("memory_only", True),
                   batch_size=data.get("batch_size", 16), **kw)
