"""Per-image detection-feature and pixel loading and batch packing
(counterpart of ``vlgae_tpu/data/features.py``).

Per-image ``det_feats/<img_id>.npy`` files of shape [n_box, feat_dim + 4]
(Faster-RCNN features + box coords) are loaded at batch time, optionally
subsampled to ``sample`` boxes for training, and packed into arrays padded
to a fixed box count (``pad_boxes``): by the native packer
(:mod:`.native_io`) wherever the JAX package takes it (every mode but the
gold scene graph), so that the same seed draws the same boxes, else by
NumPy. :class:`PixelLoader` reads raw ``imgs/<img_id>.npy`` pixels instead,
for the ViT patch grid of ``exp=vlgae_vit``. ``vis_box_feat`` and
``vis_pixels`` are written into page-locked memory when a card is present
(:mod:`vlgae_tpu_torch.utils.pinned`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils.pinned import host_zeros
from . import native_io


class DetFeatureLoader:
    """Loads det_feats/<img_id>.npy and packs padded batches."""

    def __init__(self, root, sg_data: Optional[dict] = None, sample: int = 35,
                 gold: bool = False, pad_boxes: int = 36,
                 feat_dim: Optional[int] = None, seed: int = 0):
        self.root = Path(root)
        self.sg_data = sg_data or {}
        self.sample = sample
        self.gold = gold
        self.pad_boxes = pad_boxes
        self.feat_dim = feat_dim
        self.rng = np.random.default_rng(seed)

    def __call__(self, img_ids: List[int]) -> Dict[str, np.ndarray]:
        B = len(img_ids)
        P = self.pad_boxes
        if self.feat_dim is None:  # infer from the first feature file
            first = np.load(str(self.root / f"{img_ids[0]}.npy"),
                            mmap_mode="r")
            self.feat_dim = first.shape[1] - 4
        if not self.gold:
            # one seed draw a batch, as the JAX package's native path draws it
            seed = int(self.rng.integers(0, 2 ** 62))
            feats, boxes, masks = native_io.load_det_feats_batch(
                [self.root / f"{i}.npy" for i in img_ids], P, self.feat_dim,
                self.sample, seed)
            return {
                "vis_box_feat": feats,
                "vis_box_mask": masks,
                "vis_rel_mask": np.zeros((B, P, P), bool),
                "vis_available": masks[:, 0].copy(),
                "vis_box": boxes,
                "vis_box_index": np.tile(np.arange(P)[None], (B, 1)),
            }
        feats = host_zeros((B, P, self.feat_dim), np.float32)
        boxes = np.zeros((B, P, 4), np.float32)
        masks = np.zeros((B, P), bool)
        rel_masks = np.zeros((B, P, P), bool)
        for i, img_id in enumerate(img_ids):
            path = self.root / f"{img_id}.npy"
            if not path.exists():
                raise FileNotFoundError(str(path))
            feat = np.load(str(path))
            if 0 < self.sample < len(feat):
                sample_id = self.rng.choice(len(feat), self.sample,
                                            replace=False)
                feat = feat[sample_id]
            else:
                feat = feat[:P]
                sample_id = np.arange(len(feat))
            n = len(feat)
            feats[i, :n] = feat[:, :-4]
            boxes[i, :n] = feat[:, -4:]
            if self.gold:
                m, rm = self._gold_mask(img_id, sample_id)
                masks[i, : len(m)] = m
                rel_masks[i, : rm.shape[0], : rm.shape[1]] = rm
            else:
                masks[i, :n] = True
        return {
            "vis_box_feat": feats,
            "vis_box_mask": masks,
            "vis_rel_mask": rel_masks,
            "vis_available": masks[:, 0].copy(),
            "vis_box": boxes,
            "vis_box_index": np.tile(np.arange(P)[None], (B, 1)),
        }

    def _gold_mask(self, img_id, sample_id):
        """Gold scene-graph masks."""
        sg = self.sg_data.get(img_id)
        if sg is None or len(sg["obj"]) == 0:
            return np.zeros(0, bool), np.zeros((0, 0), bool)
        n_obj = len(sg["obj"])
        mask = np.ones(min(len(sample_id), n_obj), bool)
        rel = np.zeros((n_obj, n_obj), bool)
        for item in sg["rel"]:
            rel[item["subj"], item["obj"]] = True
        sid = np.asarray(sample_id)
        sid = sid[sid < n_obj] if len(sid) and sid.max() >= n_obj else sid
        rel = rel[np.ix_(sid, sid)] if len(sid) else rel[:0, :0]
        return mask, rel


class PixelLoader:
    """Loads ``imgs/<img_id>.npy`` raw pixels (``[S, S, 3]`` floats) for
    :class:`~vlgae_tpu_torch.models.vis_encoder.VisViTPatchEncoder`. The
    "proposal boxes" are the ViT patch rectangles, the same for every image,
    so the keys are those of :class:`DetFeatureLoader` with ``vis_pixels``
    in place of ``vis_box_feat``."""

    def __init__(self, root, image_size: int, patch_size: int):
        from ..models.vis_encoder import patch_boxes

        self.root = Path(root)
        self.image_size = int(image_size)
        self.patch_size = int(patch_size)
        self.boxes = patch_boxes(self.image_size, self.patch_size).astype(np.float32)

    @property
    def n_patches(self) -> int:
        return len(self.boxes)

    def __call__(self, img_ids: List[int]) -> Dict[str, np.ndarray]:
        B, P, S = len(img_ids), self.n_patches, self.image_size
        pixels = host_zeros((B, S, S, 3), np.float32)
        for i, img_id in enumerate(img_ids):
            path = self.root / f"{img_id}.npy"
            if not path.exists():
                raise FileNotFoundError(str(path))
            img = np.load(str(path))
            if img.shape[:2] != (S, S):
                raise ValueError(f"{path}: expected {S}x{S} pixels, got {img.shape}")
            pixels[i] = img
        masks = np.ones((B, P), bool)
        return {
            "vis_pixels": pixels,
            "vis_box_mask": masks,
            "vis_rel_mask": np.zeros((B, P, P), bool),
            "vis_available": masks[:, 0].copy(),
            "vis_box": np.tile(self.boxes[None], (B, 1, 1)),
            "vis_box_index": np.tile(np.arange(P)[None], (B, 1)),
        }
