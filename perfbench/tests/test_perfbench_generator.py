"""The traffic generator repeats by seed and follows its length law."""

import filecmp
import os

import numpy as np

from perfbench.core import corpus


LAW = {"law": "lognormal", "median": 10.5, "sigma": 0.3, "min": 3, "max": "max_len"}
IMAGES = {"train": 6, "dev": 2, "test": 2}
VISION = {"kind": "regions", "n_box": 4, "feat_dim": 8}


def test_same_seed_same_corpus(tmp_path):
    a = corpus.make_corpus(tmp_path / "a", 2**31 + 5, IMAGES, LAW, 50, VISION)
    b = corpus.make_corpus(tmp_path / "b", 2**31 + 5, IMAGES, LAW, 50, VISION)
    c = corpus.make_corpus(tmp_path / "c", 7, IMAGES, LAW, 50, VISION)
    for name in ("train.conll", "val.conll", "vlparse.json", "det_feats/100000.npy"):
        assert filecmp.cmp(a / name, b / name, shallow=False)
    assert not filecmp.cmp(a / "train.conll", c / "train.conll", shallow=False)


def test_every_seed_gets_the_same_lengths(tmp_path):
    lens = []
    for seed in (1, 2**31 + 9):
        root = corpus.make_corpus(tmp_path / str(seed), seed, IMAGES, LAW, 50, VISION)
        lens.append(sorted(len(w) for w, _ in corpus.read_conll(root / "train.conll")))
    assert lens[0] == lens[1]


def test_length_laws():
    lens = corpus.length_multiset(LAW, 2560, 50)
    assert lens.min() >= 3 and lens.max() <= 50
    assert abs(np.median(lens) - 10.5) <= 0.5
    q1, q3 = np.quantile(np.log(lens), [0.25, 0.75])
    assert abs((q3 - q1) / 1.349 - 0.3) < 0.03  # sigma in log space
    uni = corpus.length_multiset({"law": "uniform", "min": 30, "max": 50}, 2100, 50)
    assert sorted(set(uni.tolist())) == list(range(30, 51))
    assert np.bincount(uni)[30:].min() == np.bincount(uni)[30:].max() == 100


def test_pixels_and_bert_dir(tmp_path):
    root = corpus.make_corpus(tmp_path / "p", 3, IMAGES, LAW, 64,
                              {"kind": "pixels", "image_size": 8})
    assert np.load(root / "imgs" / "100000.npy").shape == (8, 8, 3)
    assert not os.path.exists(root / "det_feats")
    d = corpus.write_bert_dir(tmp_path / "bert", corpus.corpus_words(root), {"model_type": "bert"})
    vocab = open(os.path.join(d, "vocab.txt")).read().split()
    assert vocab[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
