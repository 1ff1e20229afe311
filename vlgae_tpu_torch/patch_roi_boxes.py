"""Write the proposal-boxes file that ``eval.py`` reads for ViT predictions
(the port's counterpart of ``scripts/make_patch_roi_boxes.py``).

Under ``exp=vlgae_vit`` the visual "boxes" are the ViT patch rectangles,
the same grid for every image, so the grounding evaluator only needs a
``dev_roi_boxes.json`` that maps every image id of the split to that grid:

    python -m vlgae_tpu_torch.patch_roi_boxes --dataroot data/vlparse \\
        --split val --image-size 224 --patch-size 32

writes ``<dataroot>/dev_roi_boxes.json`` (or ``--out``); then ``eval.py
--file <run>/dev.predict.txt --dataroot <dataroot>`` scores the predictions.
"""

from __future__ import annotations

import argparse
import json
import os

from .models.vis_encoder import patch_boxes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--patch-size", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    with open(os.path.join(args.dataroot, "id_list", f"{args.split}.txt")) as f:
        img_ids = sorted({int(line.strip()) for line in f if line.strip()})
    grid = patch_boxes(args.image_size, args.patch_size).tolist()
    out = args.out or os.path.join(args.dataroot, "dev_roi_boxes.json")
    with open(out, "w") as f:
        json.dump({str(i): grid for i in img_ids}, f)
    print(f"wrote {out}: {len(img_ids)} images x {len(grid)} patch boxes")
    return out


if __name__ == "__main__":
    main()
