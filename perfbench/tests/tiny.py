"""A tiny configuration of the bert-base cell's recipe for the CPU tests."""

import copy
import json
import os

from perfbench.core import manifest

TRAFFIC = {"loop": "train", "split": "train", "alpha": 0.5,
           "images": {"train": 4, "dev": 2, "test": 2},
           "length": {"law": "lognormal", "median": 6, "sigma": 0.3, "min": 3, "max": "max_len"}}


def config(name="vlgae-bertbase"):
    with open(os.path.join(manifest.BENCH, "configs", name + ".json")) as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    c["bert"].update(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64)
    c["widths"].update(hidden=32, match_hidden=16, rank=4, mid_bottleneck=150, feat_dim=16,
                       n_box=6)
    c["max_len_train"] = 12
    c["overrides"] = c["overrides"] + [
        "_hidden_size=32", "_match_hidden_size=16", "_rank=4",
        "datamodule.train_dataloader.batch_size=8", "datamodule.train_dataloader.num_bucket=1",
        "datamodule.dev_dataloader.num_bucket=1", "datamodule.test_dataloader.num_bucket=1",
        "datamodule.max_len.train=12"]
    c["vision"].update(n_box=6, feat_dim=16, sample_boxes=5)
    c["overrides"] += ["vis_encoder.n_in=16", "datamodule.pad_boxes=6",
                       "datamodule.sample_boxes=5"]
    return c
