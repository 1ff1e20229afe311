"""The port's WordPiece tokenizer (``vlgae_tpu_torch.data.WordPieceTokenizer``)
against ``transformers.AutoTokenizer`` and vlgae_tpu's ``HFTokenizer`` on
BERT directories the test writes (``config.json`` and ``vocab.txt``, with
and without a ``tokenizer_config.json``). Ids are compared exactly."""

import json

import pytest

from vlgae_tpu_torch.data import WordPieceTokenizer

PIECES = ["the", "dog", "##s", "run", "##ning", "ca", "##fe", "##é", "naive", "na",
          "##ive", "big", "Big", "DOG", "Dog", ",", ".", "'", "-", "!", "(", ")",
          "中", "国", "a", "##b", "##c", "x", "##x", "über", "uber", "ü", "-", "$"]
WORDS = ["the", "dogs", "Dogs", "DOGS", "running", "Café", "café", "naïve", "NAÏVE",
         "über", "Über", "dog,", "(dog)", "don't", "co-op", "中国", "中文", "a中b",
         "abc", "abcabc", "x" * 100, "x" * 101, "zebra", "ﬁsh", "\x00dog", "dog​",
         "�", "", " ", "\t", "dog cat", "big!!", "$5", "[CLS]", "[cls]",
         "dog[SEP]", "Ⅻ", "ｆｕｌｌ", "é", "é"]


def _write(path, specials_first, config=None):
    path.mkdir()
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    if specials_first:  # [CLS] on line 0
        specials = ["[CLS]", "[PAD]", "[UNK]", "[SEP]", "[MASK]"]
    (path / "vocab.txt").write_text("\n".join(specials + PIECES) + "\n", encoding="utf-8")
    (path / "config.json").write_text(json.dumps({"model_type": "bert"}))
    if config is not None:
        (path / "tokenizer_config.json").write_text(json.dumps(config))
    return str(path)


CASES = {
    "no_config": (False, None),
    "cased": (False, {"do_lower_case": False}),
    "uncased": (False, {"do_lower_case": True}),
    "cls_on_line_0": (True, None),
    "uncased_keep_accents": (False, {"do_lower_case": True, "strip_accents": False}),
    "no_cjk_split": (False, {"do_lower_case": False, "tokenize_chinese_chars": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ids_match_autotokenizer(tmp_path, case):
    from transformers import AutoTokenizer

    from vlgae_tpu.data.subword import HFTokenizer

    specials_first, config = CASES[case]
    path = _write(tmp_path / case, specials_first, config)
    hf = AutoTokenizer.from_pretrained(path)
    ours = WordPieceTokenizer(path)
    for w in WORDS:
        assert ours.encode(w) == hf(w, add_special_tokens=False)["input_ids"], repr(w)
    ref = HFTokenizer(path)
    assert ours(WORDS) == ref(WORDS)
    assert (ours.cls_id, ours.sep_id, ours.unk_id) == (ref.cls_id, ref.sep_id,
                                                      hf.unk_token_id)
    if specials_first:  # [CLS] is id 0, which both take as 1
        assert hf.cls_token_id == 0 and ours.cls_id == 1


def test_unknown_and_long_words_and_empty_results(tmp_path):
    tok = WordPieceTokenizer(_write(tmp_path / "d", False))
    unk = tok.vocab["[UNK]"]
    assert tok.encode("zebra") == [unk]  # no piece matches
    assert tok.encode("x" * 101) == [unk]  # over 100 characters
    assert tok.encode("x" * 100) == [tok.vocab["x"]] + [tok.vocab["##x"]] * 99
    assert tok.encode("\x00") == [] and tok(["\x00", " "]) == [[unk], [unk]]


def test_repeated_piece_takes_its_last_line_and_unk_is_required(tmp_path):
    d = tmp_path / "d"
    d.mkdir()
    (d / "vocab.txt").write_text("[UNK]\ndog\n[CLS]\ndog\n")
    tok = WordPieceTokenizer(str(d))
    assert tok.encode("dog") == [3] and tok.cls_id == 2 and tok.sep_id == 2
    (d / "vocab.txt").write_text("dog\n")
    with pytest.raises(ValueError, match="unknown token"):
        WordPieceTokenizer(str(d))
