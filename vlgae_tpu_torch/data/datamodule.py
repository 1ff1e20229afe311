"""Data modules: dependency CoNLL and VLParse (captions + region features).

A copy of ``vlgae_tpu/data/datamodule.py`` (NumPy host code): datasets are
lists of instance dicts; batches are padded NumPy dicts ``(x, y)``. With
``include_init_rules`` set (by the pipeline, during the warm-up epochs)
the collate of the training splits adds the rule-count targets of
``generate_rule_1o``, computed once per instance and cached on it. With
``vis_source: pixels`` (``exp=vlgae_vit``) the batches carry raw pixels and
the ViT patch grid as boxes (:class:`PixelLoader`). With ``load_vis=False``
(a recipe without a visual encoder, ``exp=lang_only``) no region feature is
read or batched. ``DepDataModule`` reads a plain CoNLL corpus; its options
``use_char`` (a ``[B, L, max_word_len]`` char-id field over a char vocabulary
of the training words), ``ignore_stop_word`` (NLTK's English stop words kept
out of the ``num_lex`` lexicalised words when the corpus is installed,
nothing otherwise; nothing is downloaded) and, for VLParse,
``use_gold_scene_graph`` and ``use_img`` (``<split>.npy`` whole-image
features, one row an image, batched as ``vis_img``) are those of the JAX
package. Where a split has a feature loader, a producer thread collates its
batches ahead of the caller (``DataModule.batches``).
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import re
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .conll import read_conll
from .features import DetFeatureLoader, PixelLoader
from .sampler import BasicSampler, ConstantTokenNumSampler
from .vocab import UNK, TokenVocabulary, Vocabulary
from ..struct.alg import isprojective
from ..utils.pinned import pinning
from ..utils.trace import count, span

# batches a producer thread keeps finished ahead of its consumer
PREFETCH = 2
_DONE = object()
# the producer threads alive, each with its stop event
_running: Dict[threading.Thread, threading.Event] = {}

_BRACKETS = {
    "-LRB-": "(", "-RRB-": ")", "-LCB-": "{", "-RCB-": "}",
    "-LSB-": "[", "-RSB-": "]",
}


def normalize_word(w: str) -> str:
    """digit->0 + PTB bracket unescape (ref: datamodule.py:285-305)."""
    w = _BRACKETS.get(w, w).replace(r"\/", "/").replace(r"\*", "*")
    return re.sub(r"\d", "0", w)


class DataModule:
    """Base: loading, vocab building, length filtering (ref: datamodule.py:18-321)."""

    INPUTS = ("id", "word", "seq_len")
    TARGETS = ("target",)
    EXTRA_VOCAB = ()

    def __init__(self, train_path=None, train_init_path=None, dev_path=None,
                 test_path=None, train_dataloader=None, dev_dataloader=None,
                 test_dataloader=None, normalize_word=True,
                 build_no_create_entry=True, max_len=None, **_):
        self.train_path = train_path
        self.train_init_path = train_init_path or train_path
        self.dev_path = dev_path
        self.test_path = test_path
        self.train_dataloader_cfg = dict(train_dataloader or {})
        self.dev_dataloader_cfg = dict(dev_dataloader or {})
        self.test_dataloader_cfg = dict(test_dataloader or {})
        self.normalize_word = normalize_word
        self.build_no_create_entry = build_no_create_entry
        self.max_len = dict(max_len or {})
        self.datasets: Dict[str, List[dict]] = {}
        self.vocabs: Dict[str, Optional[Vocabulary]] = {}
        self._has_setup = False
        # a split's feature-loader state after the last batch taken, while
        # its producer thread runs ahead (_prefetched)
        self._taken_rng: Dict[str, list] = {}

    # -- override points -----------------------------------------------------
    def _load(self, path, name) -> List[dict]:
        raise NotImplementedError

    def post_init_vocab(self):
        pass

    # -- pipeline --------------------------------------------------------------
    def setup(self):
        if self._has_setup:
            return self
        for name, path in (("train", self.train_path),
                           ("train_init", self.train_init_path),
                           ("dev", self.dev_path),
                           ("test", self.test_path)):
            if path is None:
                continue
            ds = self._load(path, name)
            for inst in ds:
                if "word" not in inst:
                    words = inst["raw_word"]
                    inst["word"] = (
                        [normalize_word(w) for w in words]
                        if self.normalize_word else list(words)
                    )
                inst.setdefault("seq_len", len(inst["word"]))
            for i, inst in enumerate(ds):
                inst["id"] = i
            self.datasets[name] = ds
        self.init_vocab()
        self.apply_max_len()
        self._has_setup = True
        return self

    def init_vocab(self):
        self.vocabs.setdefault("word", Vocabulary())
        for field in self.EXTRA_VOCAB:
            self.vocabs.setdefault(field, Vocabulary())
        no_create = (
            [self.datasets[k] for k in ("dev", "test") if k in self.datasets]
            if self.build_no_create_entry else []
        )
        if self.vocabs["word"] is not None:
            self.vocabs["word"].from_datasets(
                [self.datasets["train"]], "word",
                no_create_entry_datasets=no_create,
            )
        for field in self.EXTRA_VOCAB:
            if self.vocabs[field] is not None:
                self.vocabs[field].from_datasets(
                    [self.datasets["train"]], field
                )
        self.post_init_vocab()
        for name, vocab in self.vocabs.items():
            if vocab is None:
                raise ValueError(f"vocab {name} not initialised")

    def get_vocab_count(self):
        return {f"n_{k}": len(v) for k, v in self.vocabs.items()}

    def apply_max_len(self):
        for name, limit in self.max_len.items():
            if name in self.datasets and limit:
                self.datasets[name] = [
                    i for i in self.datasets[name] if i["seq_len"] <= limit
                ]

    # -- batching ----------------------------------------------------------------
    def make_sampler(self, name, shuffle=None):
        cfg = {
            "train": self.train_dataloader_cfg,
            "train_init": self.train_dataloader_cfg,
            "dev": self.dev_dataloader_cfg,
            "test": self.test_dataloader_cfg,
        }[name]
        ds = self.datasets[name]
        seq_len = [i["seq_len"] for i in ds]
        shuffle = (name in ("train", "train_init")) if shuffle is None else shuffle
        num_bucket = cfg.get("num_bucket", 1)
        if num_bucket > 1 and len(ds) > num_bucket:
            return ConstantTokenNumSampler(
                seq_len,
                max_token=cfg.get("token_size", 4096),
                max_sentence=cfg.get("batch_size", -1),
                num_bucket=num_bucket,
                single_sent_threshold=cfg.get("single_sent_threshold", -1),
                shuffle=shuffle,
                len_round=cfg.get("len_round", 8),
            )
        return BasicSampler(
            seq_len, batch_size=cfg.get("batch_size", 32), shuffle=shuffle,
            len_round=cfg.get("len_round", 8),
        )

    def sampler(self, name, shuffle=None):
        """The cached sampler ``batches(name, shuffle)`` iterates.

        Callers needing the batch count (progress totals, mid-epoch
        validation cadence) must read ``len()`` off THIS object: a
        fresh ``make_sampler`` re-runs the k-means bucketing and a
        differently-seeded shuffle, whose ``single_sent_threshold``
        splitting can yield a different batch count than the sampler
        actually iterated.
        """
        key = (name, shuffle)
        if not hasattr(self, "_sampler_cache"):
            self._sampler_cache = {}
        sampler = self._sampler_cache.get(key)
        if sampler is None:
            sampler = self.make_sampler(name, shuffle)
            self._sampler_cache[key] = sampler
        return sampler

    def batches(self, name, shuffle=None):
        """Yield (x, y) NumPy batch dicts, each padded to its sampler's
        ``pad_len`` (the rows are the batch's captions; padding the batch
        to a power of two is the caller's).

        Samplers are cached per (split, shuffle) so the epoch-seeded
        reshuffle advances across epochs (ref: sampler.py:89-95). Where the
        split has a feature loader (VLParse with ``load_vis``: file reads
        outside the interpreter lock), a producer thread collates the
        batches after the first while the caller works on the ones it has
        (:meth:`_prefetched`); elsewhere the collate is Python alone, which
        a thread slows, and each batch is collated when asked for.
        """
        sampler = self.sampler(name, shuffle)
        collated = self._collated(name, sampler)
        loader = getattr(self, "_feat_loaders", {}).get(name)
        if loader is None:
            yield from collated
        else:
            yield from self._prefetched(name, collated, getattr(loader, "rng", None))

    def _collated(self, name, sampler):
        ds = self.datasets[name]
        for batch_idx in sampler:
            with span("vlgae.data.collate"):
                batch = self.collate(name, [ds[i] for i in batch_idx],
                                     sampler.pad_len(batch_idx))
            yield batch

    def _prefetched(self, name, collated, rng=None):
        """The batches of ``collated``: the first collated here, then a
        producer thread (:func:`_produce`) keeps up to ``PREFETCH`` more
        ready. Counted per batch taken: ``data.prefetch_ready`` (queued
        when asked for) or ``data.prefetch_waited`` (the first, and any the
        caller blocked for, inside ``vlgae.data.wait``).

        ``rng``, the feature loader's random generator, follows the caller:
        :meth:`train_state` reads its state after the last batch taken, and
        when this generator is closed or dropped early the thread is
        stopped and the generator put back to that state, so that later
        draws are those of batches collated when asked for.
        """
        first = next(collated, _DONE)
        if first is _DONE:
            return
        count("data.prefetch_waited")
        # the state after the last batch taken, read by train_state
        taken = [_rng_state(rng)]
        self._taken_rng[name] = taken
        q = queue.Queue(PREFETCH)
        stop = threading.Event()
        # pinned batches are allocated on the caller's card
        device = torch.cuda.current_device() if pinning() else None
        thread = threading.Thread(
            target=_produce, args=(collated, rng, taken, self._taken_rng, name, q, stop, device),
            name=f"vlgae-prefetch-{name}", daemon=True)
        _running[thread] = stop
        thread.start()
        try:
            yield first
            while True:
                try:
                    item, ready = q.get_nowait(), True
                except queue.Empty:
                    with span("vlgae.data.wait"):
                        item, ready = q.get(), False
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, taken[0] = item
                count("data.prefetch_ready" if ready else "data.prefetch_waited")
                yield batch
        finally:
            stop.set()
            try:  # unblock a producer waiting to put
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            # collected on the producer's own thread, the producer puts the
            # draws back as it stops; at exit there is nothing to put back
            if thread is not threading.current_thread() and not sys.is_finalizing():
                thread.join()
                _put_back(rng, taken, self._taken_rng, name)

    def train_state(self) -> dict:
        """The host RNG state of the training splits: sampler epochs (they
        seed the shuffles) and the box-sampling generators, so a resumed
        run draws what the uninterrupted run would have (the pixel loader
        draws nothing)."""
        state = {"sampler_epoch": {}, "loader_rng": {}}
        for name in ("train", "train_init"):
            if name not in self.datasets:
                continue
            state["sampler_epoch"][name] = self.sampler(name).epoch
            loader = getattr(self, "_feat_loaders", {}).get(name)
            if hasattr(loader, "rng"):
                taken = self._taken_rng.get(name)
                state["loader_rng"][name] = (
                    loader.rng.bit_generator.state if taken is None else taken[0])
        return state

    def load_train_state(self, state: dict) -> None:
        for name, epoch in state.get("sampler_epoch", {}).items():
            self.sampler(name).set_epoch(epoch)
        for name, rng_state in state.get("loader_rng", {}).items():
            self._feat_loaders[name].rng.bit_generator.state = rng_state
            self._taken_rng.pop(name, None)

    def collate(self, name, insts, pad_len):
        raise NotImplementedError


class DepDataModule(DataModule):
    """CoNLL dependency data (ref: src/datamodule/task/dep.py)."""

    INPUTS = ("id", "word", "token", "seq_len")
    TARGETS = ("arc",)

    def __init__(self, use_tag=True, num_lex=0, num_token=99999,
                 ignore_stop_word=False, headers=None, indexes=None,
                 use_char=False, max_word_len=20, **kw):
        assert num_lex > 0 or use_tag, "nothing to build token"
        self.headers = headers or ["raw_word", "tag", "arc"]
        self.indexes = indexes or [1, 2, 3]
        self.use_tag = use_tag
        self.use_char = use_char
        self.max_word_len = max_word_len
        if use_tag:
            self.INPUTS = self.INPUTS + ("tag",)
            self.EXTRA_VOCAB = self.EXTRA_VOCAB + ("tag",)
        if use_char:
            self.INPUTS = self.INPUTS + ("char",)
        self.num_lex = num_lex
        self.num_token = num_token
        self.ignore_stop_word = ignore_stop_word
        # which stop-word list ``post_init_vocab`` used: "nltk", "empty" or None
        self.stop_words_source = None
        super().__init__(**kw)
        self.vocabs["token"] = None  # manual init
        self.include_init_rules = False
        self.token2word = None
        self.token2tag = None
        if self.use_tag and self.num_lex > 0:
            self.token_mode = "joint"
        elif self.use_tag:
            self.token_mode = "tag"
        else:
            self.token_mode = "word"

    def _load(self, path, name):
        insts = read_conll(path, self.headers, self.indexes)
        for inst in insts:
            if self.token_mode == "joint":
                inst["token"] = [
                    f"{w.lower()}:{p}"
                    for w, p in zip(inst["raw_word"], inst["tag"])
                ]
            elif self.token_mode == "tag":
                inst["token"] = list(inst["tag"])
            else:
                inst["token"] = [w.lower() for w in inst["raw_word"]]
        kept = [i for i in insts if isprojective(i["arc"])]
        return kept

    def post_init_vocab(self):
        """Token vocab: top-num_lex words x tags + <unk>:tag backoffs
        (ref: task/dep.py:81-132)."""
        from collections import Counter

        if self.use_char:
            # the char vocabulary of the training words (for CharItem)
            cv = Vocabulary()
            for inst in self.datasets["train"]:
                for w in inst["word"]:
                    cv.update(list(w.lower()))
            cv.build()
            self.vocabs["char"] = cv

        if self.token_mode == "tag":
            self.vocabs["token"] = self.vocabs["tag"]
            self.token2tag = list(range(len(self.vocabs["token"])))
            return

        count, word_count = Counter(), Counter()
        for inst in self.datasets["train"]:
            lowered = [w.lower() for w in inst["word"]]
            word_count.update(lowered)
            if self.token_mode == "joint":
                count.update(zip(lowered, inst["tag"]))

        if self.ignore_stop_word:
            try:
                from nltk.corpus import stopwords

                sw = set(stopwords.words("english"))
                self.stop_words_source = "nltk"
            except (ImportError, LookupError, OSError):  # no nltk, or no corpus
                sw = set()
                self.stop_words_source = "empty"
            used = [w for w, _ in word_count.most_common(self.num_lex + len(sw))
                    if w not in sw][: self.num_lex]
            used = set(used)
        else:
            used = set(w for w, _ in word_count.most_common(self.num_lex))

        processed = {}
        if self.token_mode == "joint":
            for (w, p), c in count.most_common():
                if w in used:
                    processed[f"{w}:{p}"] = c
                    if len(processed) == self.num_token:
                        break
            for p in self.vocabs["tag"].idx2word:
                if p in ("<pad>", "<unk>"):
                    continue
                processed[f"{UNK}:{p}"] = 100000
        else:
            for w, c in word_count.most_common():
                if w in used:
                    processed[w] = c
                    if len(processed) == self.num_token:
                        break

        token_vocab = TokenVocabulary()
        token_vocab.word_count.update(processed)
        token_vocab.build()
        self.vocabs["token"] = token_vocab

        if self.token_mode == "joint":
            pairs = [token_vocab.idx2word[i].rsplit(":", 1)
                     for i in range(2, len(token_vocab))]
            ws = ["<pad>", "<unk>"] + [p[0] for p in pairs]
            ts = ["<pad>", "<unk>"] + [p[1] for p in pairs]
            self.token2word = [self.vocabs["word"][w] for w in ws]
            self.token2tag = [self.vocabs["tag"][t] for t in ts]
        else:
            self.token2word = [
                self.vocabs["word"][token_vocab.idx2word[i]]
                for i in range(len(token_vocab))
            ]

    def _index_instance(self, inst):
        """Vocab-index an instance ONCE and cache the id arrays on it —
        the reference's fastNLP datasets are indexed once at setup
        (ref: datamodule.py:189-204); re-running Python dict lookups per
        batch per epoch is pure host-side waste."""
        wv, tv = self.vocabs["word"], self.vocabs.get("tag")
        kv = self.vocabs["token"]
        cv = self.vocabs.get("char")
        inst["_word_ids"] = np.array([wv[w] for w in inst["word"]],
                                     np.int32)
        inst["_token_ids"] = np.array([kv[t] for t in inst["token"]],
                                      np.int32)
        if self.use_tag:
            inst["_tag_ids"] = np.array([tv[t] for t in inst["tag"]],
                                        np.int32)
        if self.use_char:
            W = self.max_word_len
            chars = np.zeros((len(inst["word"]), W), np.int32)
            for i, w in enumerate(inst["word"]):
                cs = [cv[c] for c in w.lower()[:W]]
                chars[i, : len(cs)] = cs
            inst["_char_ids"] = chars
        return inst

    def collate(self, name, insts, pad_len):
        B, L = len(insts), pad_len
        x = {
            "id": np.array([i["id"] for i in insts], np.int32),
            "seq_len": np.array([i["seq_len"] for i in insts], np.int32),
            "word": np.zeros((B, L), np.int32),
            "token": np.zeros((B, L), np.int32),
        }
        if self.use_tag:
            x["tag"] = np.zeros((B, L), np.int32)
        if self.use_char:
            x["char"] = np.zeros((B, L, self.max_word_len), np.int32)
        y = {"arc": np.zeros((B, L), np.int32)}
        for b, inst in enumerate(insts):
            n = inst["seq_len"]
            if "_word_ids" not in inst:
                self._index_instance(inst)
            x["word"][b, :n] = inst["_word_ids"]
            x["token"][b, :n] = inst["_token_ids"]
            if self.use_tag:
                x["tag"][b, :n] = inst["_tag_ids"]
            if self.use_char:
                x["char"][b, :n] = inst["_char_ids"]
            y["arc"][b, :n] = inst["arc"]
        if self.include_init_rules and name in ("train", "train_init"):
            from ..models.dmv_init import generate_rule_1o

            y["dec_rule"] = np.zeros((B, L, 2, 2, 2), np.float32)
            y["attach_rule"] = np.zeros((B, L, L, 2), np.float32)
            y["root_rule"] = np.zeros((B, L), np.float32)
            for b, inst in enumerate(insts):
                n = inst["seq_len"]
                if n == 0:
                    continue
                rules = inst.get("_init_rules")
                if rules is None:
                    rules = generate_rule_1o(list(inst["arc"]))
                    inst["_init_rules"] = rules
                y["dec_rule"][b, :n] = rules["dec_rule"]
                y["attach_rule"][b, :n, :n] = rules["attach_rule"]
                y["root_rule"][b, :n] = rules["root_rule"]
        return x, y


class VLParseDataModule(DepDataModule):
    """Adds vision inputs/targets (ref: src/datamodule/task/vlparse.py)."""

    TARGETS = ("arc", "sg_type", "sg_box", "sg_mask")

    def __init__(self, use_img=False, use_gold_scene_graph=False,
                 sg_path=None, pad_boxes=36, sample_boxes=35,
                 vis_source="det_feats", vit_image_size=224,
                 vit_patch_size=32, load_vis=True, **kw):
        self.load_vis = bool(load_vis)
        self.use_img = use_img
        self.use_gold_scene_graph = use_gold_scene_graph
        self.pad_boxes = pad_boxes
        self.sample_boxes = sample_boxes
        # 'det_feats': Faster-RCNN region features; 'pixels': raw
        # imgs/<id>.npy pixels for the ViT patch grid of exp=vlgae_vit
        if vis_source not in ("det_feats", "pixels"):
            raise ValueError(f"unknown vis_source {vis_source!r}")
        self.vis_source = vis_source
        self.vit_image_size = vit_image_size
        self.vit_patch_size = vit_patch_size
        self.sg_data = {}
        if sg_path and os.path.exists(sg_path):
            with open(sg_path) as f:
                self.sg_data = {
                    inst["coco_id"]: inst for inst in json.load(f)
                    if isinstance(inst, dict)
                }
            if use_gold_scene_graph:
                raw = os.path.join(
                    os.path.split(sg_path)[0], "vlparse_train_sg_raw.json"
                )
                if os.path.exists(raw):
                    with open(raw) as f:
                        self.sg_data.update(
                            {i["coco_id"]: i for i in json.load(f)}
                        )
        self._feat_loaders: Dict[str, object] = {}
        super().__init__(**kw)

    def _load(self, path, name):
        insts = super()._load(path + ".conll", name)
        folder, filename = os.path.split(path)
        id_path = Path(folder) / "id_list" / (filename + ".txt")
        with open(id_path) as f:
            img_id = [int(line.strip()) for line in f]
        if len(img_id) != len(insts):
            img_id = [i for i in img_id for _ in range(5)]
        # whole-image features, one row an image (five captions each)
        img_feat = None
        if self.load_vis and self.use_img and os.path.exists(path + ".npy"):
            img_feat = np.load(path + ".npy").repeat(5, 0)
        for i, inst in enumerate(insts):
            inst["img_id"] = img_id[i]
            inst["img_sent_id"] = i % 5
            if img_feat is not None and i < len(img_feat):
                inst["vis_img"] = img_feat[i]
            self._process_sg(inst)
        feat_dir = Path(folder) / (
            "gold_feats" if self.use_gold_scene_graph else "det_feats"
        )
        if self.load_vis and self.vis_source == "pixels":
            self._feat_loaders[name] = PixelLoader(
                Path(folder) / "imgs", image_size=self.vit_image_size,
                patch_size=self.vit_patch_size)
        elif self.load_vis:
            self._feat_loaders[name] = DetFeatureLoader(
                feat_dir, self.sg_data,
                sample=(self.sample_boxes
                        if name in ("train", "train_init") else 0),
                gold=self.use_gold_scene_graph, pad_boxes=self.pad_boxes,
            )
        if name in ("dev", "test") or self.use_gold_scene_graph:
            insts = [i for i in insts if i["has_sg"]]
        return insts

    def _process_sg(self, inst):
        """Build per-token gold alignment targets (ref: vlparse.py:174-210)."""
        from itertools import chain

        img_id = inst["img_id"]
        if img_id not in self.sg_data:
            txt2sg, rels, id2node = {}, [], {}
        else:
            sg = self.sg_data[img_id]
            rels = sg["rel"]
            txt2sg = sg["txt2sg"][inst["img_sent_id"]]
            id2node = {n["id"]: n for n in chain(sg["obj"], sg["rel"])}
        typestr2id = {"OBJ": 1, "ATTR": 2, "REL": 3}
        gold_box, tok_type = [], []
        for i in range(len(inst["raw_word"])):
            key = str(i)
            if key in txt2sg:
                al = txt2sg[key]
                tok_type.append(typestr2id[al["type"]])
                if tok_type[-1] == 3:
                    node = id2node[al["preferred"]]
                    subj, obj = id2node[node["subj"]], id2node[node["obj"]]
                    gold_box.append(_get_box(subj) + _get_box(obj))
                else:
                    gold_box.append(_get_box(id2node[al["preferred"]]) + [0.0] * 4)
            else:
                tok_type.append(0)
                gold_box.append([0.0] * 8)
        inst["sg_type"] = tok_type
        inst["sg_box"] = gold_box
        inst["sg_mask"] = [t != 0 for t in tok_type]
        inst["has_sg"] = img_id in self.sg_data

    def collate(self, name, insts, pad_len):
        x, y = super().collate(name, insts, pad_len)
        B, L = len(insts), pad_len
        y["sg_type"] = np.zeros((B, L), np.int32)
        y["sg_box"] = np.zeros((B, L, 8), np.float32)
        y["sg_mask"] = np.zeros((B, L), bool)
        for b, inst in enumerate(insts):
            n = inst["seq_len"]
            y["sg_type"][b, :n] = inst["sg_type"]
            y["sg_box"][b, :n] = inst["sg_box"]
            y["sg_mask"][b, :n] = inst["sg_mask"]
        if self.load_vis:
            t0 = time.perf_counter_ns()
            with span("vlgae.data.pack"):
                vis = self._feat_loaders[name]([i["img_id"] for i in insts])
            # host time on whichever thread collates, which the profiler may not record
            count("data.pack_us", (time.perf_counter_ns() - t0) // 1000)
            count("data.pack_images", len(insts))
            count("data.pack_bytes", sum(v.nbytes for v in vis.values()))
            y["vis_box"] = vis.pop("vis_box")
            x.update(vis)
        x["img_id"] = np.array([i["img_id"] for i in insts], np.int64)
        if "vis_img" in insts[0]:
            x["vis_img"] = np.stack([i["vis_img"] for i in insts]).astype(np.float32)
        return x, y


def _rng_state(rng) -> Optional[dict]:
    return None if rng is None else rng.bit_generator.state


def _put(q, item, stop) -> None:
    """``q.put(item)``, given up once ``stop`` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            pass


def _produce(collated, rng, taken, cells, name, q, stop, device) -> None:
    """The producer thread of :meth:`DataModule._prefetched`: puts each
    batch of ``collated`` into ``q`` with the loader generator's state
    after it, then ``_DONE``, until ``stop`` is set, and when stopped puts
    the generator back to the batches taken. An exception goes into ``q``
    in place of its batch, for the consumer to raise."""
    # what the consumer raises if something other than an Exception ends the thread
    item = RuntimeError("the batch producer thread stopped")
    try:
        if device is not None:
            torch.cuda.set_device(device)
        while not stop.is_set():
            batch = next(collated, _DONE)
            if batch is _DONE:
                item = _DONE
                break
            _put(q, (batch, _rng_state(rng)), stop)
    except Exception as e:  # raised again by the consumer's next()
        item = e
    finally:
        collated.close()
        _put(q, item, stop)
        if stop.is_set():
            _put_back(rng, taken, cells, name)
        _running.pop(threading.current_thread(), None)


@atexit.register
def _stop_running() -> None:
    """Stop and join the producers still alive at exit, while threads can
    still run: a daemon thread that is inside C++ code (a pinned
    allocation) when the interpreter finalizes aborts the process."""
    for stop in list(_running.values()):
        stop.set()
    for thread in list(_running):
        thread.join()


def _put_back(rng, taken, cells, name) -> None:
    """Set ``rng`` to the state after the last batch taken, ``taken[0]``,
    and drop the split's entry ``cells[name]`` if it is still ``taken``."""
    if rng is not None:
        rng.bit_generator.state = taken[0]
    if cells.get(name) is taken:
        cells.pop(name, None)


def _get_box(obj):
    return [obj["x"], obj["y"], obj["x"] + obj["width"],
            obj["y"] + obj["height"]]
