"""The port's standard-library ``tokenizer.json`` reader
(``agentainer_tpu_torch/engine/tokenizer.py::HFTokenizer``) against the
reference's ``HFTokenizer`` over ``tokenizers``.

Two tokenizers of Llama-3's pipeline (its split pattern, byte-level
pre-tokenizer, BPE, ``ByteLevel`` decoder): the committed fixture
(``tests/fixtures/llama3_style_tokenizer.json``, written by
``scripts/make_tokenizer_fixture.py``, with ``ignore_merges``, Llama-3's
post-processor and specials) and tokenizers trained here, with and without
``ignore_merges``, merges as pairs and as ``"a b"`` strings. Ids, decoded
text, ``vocab_size`` and the special ids must be equal: on fixed strings,
on hypothesis text, with the specials inside text, and for ``decode`` of
out-of-vocabulary and special ids.

Unicode versions: the port classifies characters with Python's
``unicodedata`` (15.0.0 on Python 3.12); ``tokenizers`` 0.22.2 splits with
Oniguruma (``onig`` 6.5.1), whose tables know Unicode 16.0's letters
(``test_unicode_versions_of_both_sides`` shows one). Every code point
Python's tables assign is assigned in both, so the generated text keeps to
those (no ``Cn``, no surrogates).
"""

import json
import os
import subprocess
import sys
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

from agentainer_tpu.engine.tokenizer import HFTokenizer as RefTokenizer
from agentainer_tpu.engine.tokenizer import load_tokenizer as ref_load
from agentainer_tpu_torch.engine import tokenizer as port_tok
from agentainer_tpu_torch.engine.tokenizer import LLAMA3_SPLIT, ByteTokenizer, HFTokenizer, load_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "llama3_style_tokenizer.json")
EXPECTED = os.path.join(ROOT, "tests", "fixtures", "llama3_style_tokenizer.expected.json")

FIXED = (
    "Hello, world! I'm here; you're there, they've gone, we'll see, he'd know.",
    "IT'S 'S DON'T WE'LL I'D THEY'RE WE'VE I'M x'ſ 'S 'T 'Ll 'rE ' s 'x '",
    "1 22 333 4444 55555 666666 7777777 a1b22c333d4444 ١٢٣٤ ½⅔ Ⅻ",
    "line one\r\nline two\rline three\n\n\nend  ",
    "\r\n\r\n  \n \n\t\n", "trailing spaces   ", "   ", " ", "\n", "a b c",
    "   leading spaces and\ttabs\t\there", "x  \ty", "x \n y", "!!! ??? ... --- ***\n\n",
    "emoji 😀 👍🏽 👨‍👩‍👧‍👦 🇺🇸 ✔️ end", "😀😀😀 a😀b",
    "中文字符和日本語のテキスト、한국어 텍스트。", "漢字かなカナ123",
    "combining: é ä ñ ́alone, Zalgo z̶͓a̷", "́́abc", " ́x",
    "spaces: a b c　d e  f g\x85h  i", "NBSP word   word",
    '{"tool": "search", "args": {"q": "agentainer", "n": 5}}\n',
    "def f(x):\n    return x ** 2  # square\n",
    "Ünïcödé ÀÉÎÕÜ ßẞ ﬁ ﬂ Ωμέγα Кириллица עברית العربية हिन्दी",
)
SPECIAL_TEXT = (
    "<|begin_of_text|>Hi there<|end_of_text|> and <|begin_of_text|>",
    "<|end_of_text|>", "a<|begin_of_text|><|begin_of_text|>b", "<|begin_of_text", "<|end_of_text|>>",
)


def _pair(path):
    return HFTokenizer(str(path)), RefTokenizer(str(path))


def _same(port, ref, text):
    got, want = port.encode(text), ref.encode(text)
    assert got == want, (text, got, want)
    assert port.encode(text, add_bos=False) == ref.encode(text, add_bos=False)
    assert port.decode(got) == ref.decode(want), text


@pytest.fixture(scope="module")
def fixture_pair():
    return _pair(FIXTURE)


# ---------------------------------------------------------------------------
# the committed fixture


def test_fixture_matches_the_reference_and_its_committed_ids(fixture_pair):
    port, ref = fixture_pair
    doc = json.load(open(EXPECTED, encoding="utf-8"))
    assert (port.vocab_size, port.bos_id, port.eos_id, port.pad_id) == (
        ref.vocab_size, ref.bos_id, ref.eos_id, ref.pad_id,
    ) == (doc["vocab_size"], doc["specials"]["<|begin_of_text|>"], doc["specials"]["<|end_of_text|>"], 0)
    for case in doc["cases"]:
        ids = port.encode(case["text"], add_bos=False)
        assert ids == case["ids"], case["text"]
        assert ids[0] == port.bos_id  # the file's TemplateProcessing
        assert port.decode(ids) == case["decoded"] == ref.decode(ids)
        # the reference's encode: the post-processor's bos, then its own
        assert port.encode(case["text"]) == [port.bos_id] + ids == ref.encode(case["text"])


def test_fixture_is_reproduced_by_its_script():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "make_tokenizer_fixture.py"), "--check"],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("text", FIXED + SPECIAL_TEXT)
def test_fixture_fixed_strings(fixture_pair, text):
    _same(*fixture_pair, text)


def test_round_trip_gives_back_text_without_specials(fixture_pair):
    """decode ∘ encode gives the text back, less the specials and, as the
    reference's decode drops pad id 0 (byte-level "!"), a lone "!"."""
    port, _ = fixture_pair
    assert port._vocab["!"] == port.pad_id == 0
    for text in FIXED:
        ids = port.encode(text)
        want = text if 0 not in ids else text.replace("!", "", ids.count(0))
        assert port.decode(ids) == want
    assert port.decode(port.encode(SPECIAL_TEXT[0])) == "Hi there and "


def test_decode_of_special_out_of_vocabulary_and_split_bytes(fixture_pair):
    """Ids are the model's (non-negative; the reference's binding refuses a
    negative one): specials and ids past the vocabulary are left out, and
    a multi-byte character split over tokens decodes once they are
    joined."""
    port, ref = fixture_pair
    table = port_tok._byte_chars()
    e_first = port._vocab[table[0xC3]]  # the first byte of "é" alone
    cases = [
        [port.bos_id, port.eos_id, port.pad_id], [10**6, port.vocab_size, port.vocab_size + 7],
        [e_first], [e_first, port._vocab[table[0xA9]]], [*port.encode("Hello", add_bos=False), port.eos_id, 10**6, e_first],
    ]
    for ids in cases:
        assert port.decode(ids) == ref.decode(ids), ids


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.integers(min_value=0, max_value=3100), max_size=40))
def test_decode_of_any_ids_matches(fixture_pair, ids):
    port, ref = fixture_pair
    assert port.decode(ids) == ref.decode(ids)


# text over code points Python's tables assign (assigned in both sides'
# tables), weighted toward what the split pattern tells apart
_ASSIGNED = st.characters(codec="utf-8", exclude_categories=("Cn", "Cs"))
_PATTERN_CHARS = st.sampled_from(list("'sStTrReEvVmMlLdDſ 0123456789\r\n\t\x0b\x0c\x85 　.,!?-_\"<|>"))
_TEXT = st.text(st.one_of(_PATTERN_CHARS, _ASSIGNED), max_size=60)
_TEXT_WITH_SPECIALS = st.lists(
    st.one_of(st.text(st.one_of(_PATTERN_CHARS, _ASSIGNED), max_size=12),
              st.sampled_from(["<|begin_of_text|>", "<|end_of_text|>"])),
    max_size=8,
).map("".join)


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_TEXT)
def test_fixture_hypothesis_text(fixture_pair, text):
    _same(*fixture_pair, text)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_TEXT_WITH_SPECIALS)
def test_fixture_hypothesis_text_with_specials(fixture_pair, text):
    _same(*fixture_pair, text)


def test_unicode_versions_of_both_sides():
    """A letter assigned in Unicode 16.0 (U+1E5D0, OL ONAL LETTER O): the
    reference's split (Oniguruma) joins it to the letters around it;
    Python's tables, where they predate 16.0, leave it unassigned and the
    port splits before it (as the prefix of the letters after it).
    Generated text keeps to what Python's tables assign."""
    text = "ab\U0001e5d0cd"
    split = pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False)
    assert [p for p, _ in split.pre_tokenize_str(text)] == [text]
    known = unicodedata.category("\U0001e5d0") != "Cn"
    assert port_tok._llama3_split(text) == ([text] if known else ["ab", "\U0001e5d0cd"]), (
        unicodedata.unidata_version
    )


# ---------------------------------------------------------------------------
# tokenizers trained here with Llama-3's pipeline

_CORPUS = [
    "Agents keep their sessions; the engine's KV cache survives a crash. " * 3,
    "Numbers 1234567 and 89, dates 2026-10-18, versions v3.11.2 and x86_64.\r\n" * 3,
    "Ünïcödé wörds, naïve café, straße; Ελληνικά και русский текст; 中文 日本語 한국어.\n" * 3,
    "emoji 😀👍🏽 and tabs\tand   spaces   \n\n code: def f(x): return x**2  # ok\n" * 3,
]


def _train(ignore_merges: bool, vocab: int = 700) -> Tokenizer:
    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    docs = sorted(os.path.join(ROOT, "docs", f) for f in os.listdir(os.path.join(ROOT, "docs")))
    texts = _CORPUS + [open(p, encoding="utf-8").read() for p in docs[:3]]
    tok.train_from_iterator(texts, trainers.BpeTrainer(
        vocab_size=vocab, show_progress=False, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    ))
    tok.add_special_tokens(["<|begin_of_text|>", "<|end_of_text|>"])
    tok.add_tokens(["<tool>", "héllo"])  # added, not special: decoded like vocabulary tokens
    return tok


@pytest.fixture(scope="module", params=[(True, "pairs"), (False, "pairs"), (True, "strings"), (False, "strings")],
                ids=lambda p: f"ignore_merges={p[0]}-merges_as_{p[1]}")
def trained_pair(request, tmp_path_factory):
    ignore_merges, merges = request.param
    doc = json.loads(_train(ignore_merges).to_str())
    if merges == "strings":
        doc["model"]["merges"] = [" ".join(m) for m in doc["model"]["merges"]]
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    path.write_text(json.dumps(doc, ensure_ascii=False))
    return _pair(path)


def test_trained_fixed_strings_and_specials(trained_pair):
    port, ref = trained_pair
    assert (port.vocab_size, port.bos_id, port.eos_id) == (ref.vocab_size, ref.bos_id, ref.eos_id)
    for text in FIXED + SPECIAL_TEXT + ("a<tool>b héllo <tool>", "héllohéllo"):
        _same(port, ref, text)
    ids = list(range(port.vocab_size + 3))
    assert port.decode(ids) == ref.decode(ids)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                  HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_trained_hypothesis_text(trained_pair, text):
    _same(*trained_pair, text)


def test_reference_bos_fallbacks_without_the_specials(tmp_path):
    """No ``<|begin_of_text|>``/``<|end_of_text|>``: bos 1 and eos 2, as the
    reference's ``or`` gives."""
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(_CORPUS, trainers.BpeTrainer(
        vocab_size=400, show_progress=False, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    ))
    path = tmp_path / "tokenizer.json"
    path.write_text(tok.to_str())
    port, ref = _pair(path)
    assert (port.bos_id, port.eos_id, port.vocab_size) == (ref.bos_id, ref.eos_id, ref.vocab_size) == (1, 2, 400)
    _same(port, ref, "no specials here, 123")


# ---------------------------------------------------------------------------
# load_tokenizer and what the reader refuses


def test_load_tokenizer_chooses_each(tmp_path):
    assert isinstance(load_tokenizer(512), ByteTokenizer)
    assert isinstance(load_tokenizer(512, str(tmp_path)), ByteTokenizer)  # no tokenizer.json
    (tmp_path / "tokenizer.json").write_text(open(FIXTURE, encoding="utf-8").read())
    tok = load_tokenizer(128256, str(tmp_path))
    assert isinstance(tok, HFTokenizer)
    ref = ref_load(128256, str(tmp_path))
    assert isinstance(ref, RefTokenizer)
    assert tok.encode("hi there") == ref.encode("hi there")


def _mixtral_style():
    """Mixtral's tokenizer.json family: Metaspace-style normalizer, BPE with
    byte fallback, Replace/ByteFallback/Fuse/Strip decoders."""
    tok = Tokenizer(models.BPE(byte_fallback=True, unk_token="<unk>", fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.pre_tokenizer = None
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(), decoders.Strip(" ", 1, 0),
    ])
    tok.train_from_iterator(_CORPUS, trainers.BpeTrainer(
        vocab_size=300, show_progress=False, special_tokens=["<unk>", "<s>", "</s>"],
    ))
    return json.loads(tok.to_str())


@pytest.mark.parametrize("component", ["whole", "normalizer", "model", "decoder", "pre_tokenizer"])
def test_other_families_raise_naming_the_component_and_file(tmp_path, component):
    mixtral = _mixtral_style()
    doc = json.load(open(FIXTURE, encoding="utf-8"))
    if component == "whole":
        doc, want = mixtral, "normalizer"
    elif component == "pre_tokenizer":
        doc["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False}
        want = "pre_tokenizer"
    elif component == "model":
        doc["model"]["byte_fallback"] = True
        want = "model.byte_fallback"
    else:
        doc[component] = mixtral[component]
        want = component
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(doc, ensure_ascii=False))
    with pytest.raises(NotImplementedError) as e:
        load_tokenizer(32000, str(tmp_path))
    assert str(path) in str(e.value) and want in str(e.value)


def test_reader_loads_no_tokenizers_and_no_regex():
    """In a fresh interpreter where ``tokenizers`` and ``regex`` cannot be
    imported (the machine with the card has neither), the reader loads the
    fixture and gives its committed ids."""
    code = f"""
import json, os, shutil, sys, tempfile
sys.modules["tokenizers"] = None
sys.modules["regex"] = None
from agentainer_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer
d = tempfile.mkdtemp()
shutil.copy({FIXTURE!r}, os.path.join(d, "tokenizer.json"))
tok = load_tokenizer(128256, d)
doc = json.load(open({EXPECTED!r}, encoding="utf-8"))
ok = isinstance(tok, HFTokenizer) and all(
    tok.encode(c["text"], add_bos=False) == c["ids"] and tok.decode(c["ids"]) == c["decoded"]
    for c in doc["cases"]
)
shutil.rmtree(d)
print(json.dumps([ok, sorted(m for m in sys.modules if m.split(".")[0] in ("tokenizers", "regex")
                             and sys.modules[m] is not None)]))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": ":".join(p for p in sys.path if p), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
