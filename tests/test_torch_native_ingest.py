"""The port's native C++ CSV parser (`avenir_tpu_torch/native`) against its
Python row parser and against the JAX package's `parse_csv_native`, on the
same bytes: columns byte-identical (float32 bits, int32 codes, id strings),
the same error messages, and a build that several processes may start at
once on an empty build directory.

No token of these corpora parses to other bits in the two parsers. Where
the reference's native and Python parsers differ on a token (double
rounding: 1.000000059604644775390625001), the port's native parser follows
the reference's native one (test_double_rounding_token_...).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.data import (call_hangup_schema as jax_hangup_schema,
                             generate_call_hangup as jax_generate_hangup)
from avenir_tpu.native.ingest import parse_csv_native as jax_parse_native
from avenir_tpu_torch import obs
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                   generate_churn, generate_elearn)
from avenir_tpu_torch.native import ingest

ROOT = Path(__file__).resolve().parents[1]


def engine_of(engine: str) -> str:
    """The parser a job or parse with `engine` runs where it applies: the
    native one under auto or native when it is built, else Python's."""
    native = engine in ("auto", "native") and ingest.native_available()
    return "native" if native else "python"


def parse_engines(rec) -> set:
    """The parsers of a captured run's `stream.parse` spans."""
    return {sp.attrs["engine"] for sp in rec.spans()
            if sp.name == "stream.parse"}


@pytest.fixture(scope="module", autouse=True)
def built():
    """g++ is in the environment the tests run in: the native parser must
    build (a missing build would turn these tests into Python against
    Python)."""
    assert ingest.native_available()


def parse_both(source, schema, **kw):
    py = Dataset.from_csv(source, schema, engine="python", **kw)
    nat = Dataset.from_csv(source, schema, engine="native", **kw)
    assert (py.engine, nat.engine) == ("python", "native")
    return py, nat


def assert_same_columns(a: Dataset, b: Dataset, schema) -> None:
    assert len(a) == len(b)
    for fld in schema.fields:
        x, y = a.column(fld.ordinal), b.column(fld.ordinal)
        assert x.dtype == y.dtype, fld.name
        if x.dtype == object:
            assert list(x) == list(y), fld.name
        else:
            assert x.tobytes() == y.tobytes(), fld.name


def _schema(fields):
    return FeatureSchema.from_json({"fields": fields})


@pytest.mark.parametrize("data", ["churn", "elearn"])
def test_columns_byte_identical_to_python_parser(data):
    schema, gen = {"churn": (churn_schema, generate_churn),
                   "elearn": (elearn_schema, generate_elearn)}[data]
    text = gen(5000, seed=9, as_csv=True)
    py, nat = parse_both(text, schema())
    assert_same_columns(py, nat, schema())
    np.testing.assert_array_equal(py.labels(), nat.labels())
    codes_p, bins_p = py.feature_codes()
    codes_n, bins_n = nat.feature_codes()
    assert bins_p == bins_n
    np.testing.assert_array_equal(codes_p, codes_n)


def test_file_path_and_bytes_sources(tmp_path):
    schema = churn_schema()
    p = tmp_path / "churn.csv"
    p.write_text(generate_churn(100, seed=10, as_csv=True))
    py, nat = parse_both(str(p), schema)
    assert len(nat) == len(py) == 100
    assert list(nat.ids()) == list(py.ids())
    assert_same_columns(nat, Dataset.from_csv(p.read_bytes(), schema,
                                              engine="native"), schema)


def test_unknown_categorical_raises_with_field_name():
    bad = "C1,low,med,low,good,50,open\nC2,BOGUS,med,low,good,50,open\n"
    msgs = []
    for engine in ("native", "python"):
        with pytest.raises(ValueError, match="minUsed") as e:
            Dataset.from_csv(bad, churn_schema(), engine=engine)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("value 'BOGUS' not in declared cardinality "
                                  "of field 'minUsed'")


def test_short_row_raises_as_python():
    msgs = []
    for engine in ("native", "python"):
        with pytest.raises(ValueError) as e:
            Dataset.from_csv("C1,low,med\n", churn_schema(), engine=engine)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_missing_numeric_is_nan():
    py, nat = parse_both("C1,low,med,low,good,,open\n", churn_schema())
    assert np.isnan(nat.column(5)[0]) and np.isnan(py.column(5)[0])


def test_blank_lines_and_crlf():
    text = ("C1,low,med,low,good,50,open\r\n\n  \n"
            "C2,high,low,med,poor,10,closed\r\n")
    py, nat = parse_both(text, churn_schema())
    assert len(py) == len(nat) == 2
    assert list(nat.ids()) == ["C1", "C2"]
    assert_same_columns(py, nat, churn_schema())


def test_gapped_ordinals(tmp_path):
    """Fields in the file that the schema leaves out (the reference's
    call-hangup data): the same bytes from the JAX package's generator."""
    path = tmp_path / "hangup.json"
    jax_hangup_schema().save(str(path))
    schema = FeatureSchema.from_file(str(path))
    ordinals = sorted(f.ordinal for f in schema.fields)
    assert ordinals != list(range(len(ordinals)))
    py, nat = parse_both(jax_generate_hangup(300, seed=11, as_csv=True),
                         schema)
    assert_same_columns(py, nat, schema)


def test_short_row_keeps_string_column_alignment():
    """A row shorter than a string ordinal yields an empty token, not a
    shift of later rows' ids."""
    schema = _schema([
        {"name": "a", "ordinal": 0, "dataType": "double", "feature": True},
        {"name": "id", "ordinal": 2, "id": True, "dataType": "string"}])
    py, nat = parse_both("1,x,id1\n2,y\n3,z,id3\n", schema)
    assert list(nat.ids()) == ["id1", "", "id3"] == list(py.ids())


def test_invalid_numeric_raises_like_python():
    schema = _schema([
        {"name": "x", "ordinal": 0, "dataType": "double", "feature": True},
        {"name": "y", "ordinal": 1, "dataType": "string"}])
    msgs = []
    for engine in ("native", "python"):
        with pytest.raises(ValueError) as e:
            Dataset.from_csv("1.5,ok\nabc,ok\n", schema, engine=engine)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "could not convert string to float: 'abc'"


def test_native_required_contract_errors(monkeypatch):
    text = generate_churn(5, seed=1, as_csv=True)
    with pytest.raises(ValueError, match="native"):
        Dataset.from_csv(text, churn_schema(), engine="native", keep_raw=True)
    with pytest.raises(ValueError, match="native"):
        Dataset.from_csv(text.splitlines(), churn_schema(), engine="native")
    with pytest.raises(ValueError, match="native"):
        Dataset.from_csv(text, churn_schema(), delim="::", engine="native")
    with pytest.raises(ValueError, match="unknown CSV engine"):
        Dataset.from_csv(text, churn_schema(), engine="rust")
    # no g++: auto parses in Python, native raises
    monkeypatch.setattr(ingest, "native_available", lambda: False)
    assert Dataset.from_csv(text, churn_schema()).engine == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        Dataset.from_csv(text, churn_schema(), engine="native")


def test_auto_engine_takes_the_native_parser_where_it_applies():
    text = generate_churn(50, seed=12, as_csv=True)
    with obs.capture() as rec:
        auto = Dataset.from_csv(text, churn_schema())
        raw = Dataset.from_csv(text, churn_schema(), keep_raw=True)
        lines = Dataset.from_csv(text.splitlines(True), churn_schema())
    assert (auto.engine, raw.engine, lines.engine) == ("native", "python",
                                                       "python")
    spans = [sp for sp in rec.spans() if sp.name == "stream.parse"]
    assert [sp.attrs["engine"] for sp in spans] == ["native", "python",
                                                    "python"]
    assert spans[0].attrs["nbytes"] == len(text.encode())
    assert spans[2].attrs["nbytes"] == -1
    py = Dataset.from_csv(text, churn_schema(), engine="python")
    assert_same_columns(auto, py, churn_schema())


def test_undeclared_vocabulary_is_discovered_after_the_parse():
    """A categorical with no declared cardinality comes back as tokens and
    is encoded after the parse; a later chunk's new values extend it."""
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
              {"name": "c", "ordinal": 1, "dataType": "categorical",
               "feature": True},
              {"name": "x", "ordinal": 2, "dataType": "double",
               "feature": True}]
    chunks = ["a,red,1\nb,blue,2\n", "c,green,3\nd,red,4\n"]
    for engine in ("native", "python"):
        schema = _schema(fields)
        got = [Dataset.from_csv(c, schema, engine=engine).column(1).tolist()
               for c in chunks]
        assert schema.fields[1].cardinality == ["blue", "red", "green"]
        assert got == [[1, 0], [2, 1]]


def test_string_columns_are_lazy_until_read():
    nat = Dataset.from_csv(generate_churn(20, seed=2, as_csv=True),
                           churn_schema(), engine="native")
    assert 0 in nat._lazy and 0 not in nat.columns
    sub = nat.take(np.array([3, 1]))
    assert 0 in sub._lazy
    ids = nat.ids()
    assert 0 in nat.columns and 0 not in nat._lazy
    assert list(sub.ids()) == [ids[3], ids[1]]


def test_multithreaded_parse_matches_sequential():
    """csv_parse_mt stripes the buffer at newline boundaries into disjoint
    global row ranges; columns byte-identical to the sequential parse on a
    buffer that splits (> 2 x 4 MB stripes), and an error deep in the
    second stripe reports the same token."""
    rng = np.random.default_rng(3)
    n = 360_000
    cats = ["red", "green", "blue", "violet"]
    vals = rng.random(n) * 100
    ints = rng.integers(0, 1000, n)
    rows = [f"id{i},{vals[i]:.4f},{cats[i % 4]},{ints[i]}" for i in range(n)]
    blob = ("\n".join(rows) + "\n").encode()
    assert ingest.parse_threads(len(blob), 2) == 2
    assert ingest.parse_threads(len(blob) // 3, 8) == 1
    args = (",", [1, 3], [(2, cats)], [0])
    got_seq, cols_seq, _ = ingest.parse_csv_native(blob, *args, threads=1)
    got_mt, cols_mt, _ = ingest.parse_csv_native(blob, *args, threads=2)
    assert got_seq == got_mt == n
    for o in (1, 2, 3):
        assert cols_seq[o].tobytes() == cols_mt[o].tobytes()
    assert list(cols_seq[0]) == list(cols_mt[0])
    for bad, token in (("idX,not_a_number,red,7", "not_a_number"),
                       ("idX,1.0,chartreuse,7", "chartreuse")):
        rows_bad = rows[:]
        rows_bad[300_000] = bad
        with pytest.raises(ingest.NativeParseError, match=token) as e:
            ingest.parse_csv_native(("\n".join(rows_bad) + "\n").encode(),
                                    *args, threads=2)
        assert e.value.row == 300_000 and e.value.token == token


FUZZ_SCHEMA = [
    {"name": "id", "ordinal": 0, "dataType": "string", "id": True},
    {"name": "a", "ordinal": 1, "dataType": "double", "feature": True,
     "min": -100, "max": 100},
    {"name": "c", "ordinal": 2, "dataType": "categorical", "feature": True,
     "cardinality": ["x", "y", "z"]},
    {"name": "b", "ordinal": 3, "dataType": "double", "feature": True,
     "min": -100, "max": 100},
    {"name": "cls", "ordinal": 4, "dataType": "categorical", "class": True,
     "cardinality": ["neg", "pos"]}]


def _fuzz_text(rng) -> str:
    """Random rows with whitespace, blank lines, negatives, exponent floats
    and empty numeric fields."""
    cats, classes = ["x", "y", "z"], ["neg", "pos"]
    lines = []
    for i in range(rng.integers(5, 60)):
        kind = rng.random()
        a = f"{rng.normal() * 50:.4f}"
        if kind < 0.1:
            a = f"{rng.normal():.3e}"
        elif kind < 0.2:
            a = ""
        b = f"{int(rng.integers(-99, 99))}"
        pad = " " * int(rng.integers(0, 3))
        lines.append(f"{pad}r{i},{a},{pad}{cats[rng.integers(0, 3)]}"
                     f"{pad},{b},{classes[rng.integers(0, 2)]}")
        if rng.random() < 0.15:
            lines.append("")
    return "\n".join(lines) + "\n"


def test_fuzz_native_matches_python_parser():
    """Differential fuzz: byte-identical columns from both engines."""
    schema = _schema(FUZZ_SCHEMA)
    rng = np.random.default_rng(99)
    for _ in range(10):
        py, nat = parse_both(_fuzz_text(rng), schema)
        assert_same_columns(py, nat, schema)


def test_double_rounding_token_follows_the_reference_native_parser():
    """The token where the two parsers differ: 1.000000059604644775390625001
    lies just above 1 + 2^-24, the midpoint between the float32 values 1
    and 1 + 2^-23. The Python parser rounds it to float64 first, which
    lands on the midpoint, and then to float32, where the tie goes to the
    even 1.0 (double rounding); the native parser hands it (more than 9
    fraction digits) to strtof, which rounds once, up. The port's native
    parser gives the reference native parser's bits."""
    token = "1.000000059604644775390625001"
    data = f"{token}\n".encode()
    port = ingest.parse_csv_native(data, ",", [0], [], [])[1][0]
    ref = jax_parse_native(data, ",", [0], [], [])[1][0]
    assert port.tobytes() == ref.tobytes()
    assert port.view(np.uint32).tolist() == [0x3F800001]
    schema = _schema([{"name": "x", "ordinal": 0, "dataType": "double",
                       "feature": True}])
    py = Dataset.from_csv(data, schema, engine="python").column(0)
    assert py.view(np.uint32).tolist() == [0x3F800000]


CORPORA = {
    "churn": lambda: generate_churn(3000, seed=21, as_csv=True),
    "elearn": lambda: generate_elearn(3000, seed=22, as_csv=True),
    "hangup": lambda: jax_generate_hangup(3000, seed=23, as_csv=True),
    "fuzz": lambda: "".join(_fuzz_text(np.random.default_rng(s))
                            for s in range(20)),
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_columns_byte_identical_to_jax_native_parser(corpus):
    """The same bytes through the JAX package's parse_csv_native and the
    port's: every column bit for bit, ids equal, the row count equal."""
    data = CORPORA[corpus]().encode()
    first = data.split(b"\n")[0].split(b",")
    width = len(first)
    numeric = [o for o in range(1, width)
               if first[o].strip().lstrip(b"-").replace(b".", b"").isdigit()]
    strings = [0] + [o for o in range(1, width) if o not in numeric]
    ref = jax_parse_native(data, ",", numeric, [], strings)
    got = ingest.parse_csv_native(data, ",", numeric, [], strings)
    assert got[0] == ref[0]
    for o in numeric:
        assert got[1][o].tobytes() == ref[1][o].tobytes()
    for o in strings:
        assert list(got[1][o]) == list(ref[1][o])
    assert ingest.extract_column_raw(data, ",", 0) == b"".join(
        t.encode() + b"\n" for t in got[1][0])


_PROBE = """
import sys
from pathlib import Path
import avenir_tpu_torch.native.ingest as ni
ni.BUILD_ROOT = Path(sys.argv[1])
ok = ni.native_available()
n, cols, _ = ni.parse_csv_native(b"1.5,a\\n2.5,b\\n", ",", [0], [], [1])
print(ok, n, cols[0].tolist(), cols[1].tolist())
"""


def test_six_processes_build_one_library_at_once(tmp_path):
    """Six processes started together on an empty build directory all get
    a working parser: one compiles under the file lock, the others wait
    and load the finished library; no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _PROBE, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == \
        ["True 2 [1.5, 2.5] ['a', 'b']"] * 6
    built = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert built == ["build.lock", "libcsv_ingest.so"]


def test_a_failed_build_is_retried_not_remembered(monkeypatch, tmp_path):
    monkeypatch.setattr(ingest, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(ingest, "_lib", None)
    real = ingest._build
    calls = []

    def flaky(gxx, path):
        calls.append(path)
        if len(calls) <= 2:            # both tries of the first load
            raise subprocess.CalledProcessError(1, "g++")
        real(gxx, path)

    monkeypatch.setattr(ingest, "_build", flaky)
    assert not ingest.native_available()
    assert ingest.native_available()   # the next call builds again
    assert len(calls) == 3


def test_a_library_that_will_not_load_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setattr(ingest, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(ingest, "_lib", None)
    path = ingest.library_path(ingest._gxx())
    path.parent.mkdir(parents=True)
    path.write_bytes(b"not a shared library")
    assert ingest.native_available()
    assert path.read_bytes()[:4] == b"\x7fELF"


# ------------------------------------------------ the miners' CSR encoder
SEQ_BLOCKS = {
    "awkward": (b"T1, a ,b,\r\nT2,c,,a\n \t\r\n,,\nT3\n\nT4,zz\tq , a\n"
                b"T5,*,a,*\r\nT6,\xc3\xa9t\xc3\xa9,a"),
    "baskets": "".join(f"T{r},i{r % 7},i{(r * 3) % 11},i{r % 7}\n"
                       for r in range(500)).encode(),
    "empty": b"",
    "blank": b"\n \n\t\r\n",
}
SEQ_VOCAB = ["a", "b", "c", "zz\tq", "i1", "i3", "été", "*", ""]


def _jax_native():
    """The JAX package's native library, built by another test worker
    while this one waited: a load that failed during that build is tried
    again (the JAX package remembers a failed load)."""
    import time

    from avenir_tpu.native import ingest as jax_ingest

    for _ in range(60):
        if jax_ingest.native_available():
            return jax_ingest
        jax_ingest._build_failed = False
        time.sleep(1.0)
    raise AssertionError("the JAX package's native library does not load")


@pytest.mark.parametrize("block", sorted(SEQ_BLOCKS))
@pytest.mark.parametrize("delim", [",", "\t"])
def test_seq_encode_equals_jax_native(block, delim):
    """Codes (unknown tokens -1) and CSR offsets equal the JAX package's
    native encoder's on the same bytes and vocabulary, the tokens trimmed
    of space, tab and CR and whitespace-only lines no rows."""
    jax_ingest = _jax_native()
    data = SEQ_BLOCKS[block]
    if delim == "\t":
        data = data.replace(b",", b"\t")
    for vocab in (SEQ_VOCAB, [], ["a"]):
        got = ingest.seq_encode_native(data, delim, vocab)
        want = jax_ingest.seq_encode_native(data, delim, vocab)
        assert got[0].dtype == np.int32 and got[1].dtype == np.int64
        assert got[0].tolist() == want[0].tolist()
        assert got[1].tolist() == want[1].tolist()
    if block == "awkward" and delim == ",":
        codes, offsets = ingest.seq_encode_native(data, delim, SEQ_VOCAB)
        rows = [codes[a:b].tolist() for a, b in zip(offsets, offsets[1:])]
        assert rows == [[-1, 0, 1, 8], [-1, 2, 8, 0], [8, 8, 8], [-1],
                        [-1, 3, 0], [-1, 7, 0, 7], [-1, 6, 0]]
    assert ingest.seq_encode_native(data, "::", SEQ_VOCAB) is None


def test_csr_helpers_equal_jax():
    jax_ingest = _jax_native()
    data = SEQ_BLOCKS["awkward"]
    codes, offsets = ingest.seq_encode_native(data, ",", SEQ_VOCAB)
    for skip in (0, 1, 2, 5):
        got = ingest.csr_region_mask(offsets, skip, codes.shape[0])
        assert got.tolist() == jax_ingest.csr_region_mask(
            offsets, skip, codes.shape[0]).tolist()
    row_of, starts = ingest.csr_rows(offsets)
    j_row_of, j_starts = jax_ingest.csr_rows(offsets)
    assert row_of.dtype == np.int32
    assert row_of.tolist() == j_row_of.tolist()
    assert starts.tolist() == j_starts.tolist()
    region = ingest.csr_region_mask(offsets, 1, codes.shape[0]) & (codes >= 0)
    counts = ingest.distinct_row_code_counts(row_of, codes, region,
                                             len(SEQ_VOCAB))
    assert counts.tolist() == jax_ingest.distinct_row_code_counts(
        row_of, codes, region, len(SEQ_VOCAB)).tolist()
    assert counts.tolist() == [5, 1, 1, 1, 0, 0, 1, 1, 3]


@pytest.mark.parametrize("marker", [None, "*"])
def test_block_scan_encoder_equals_jax(tmp_path, marker):
    """The vocabulary-discovering pass 1 over blocks in turn: the same
    first-seen vocabulary, codes, offsets and item region as the JAX
    package's encoder, the marker and the empty token dropped; and
    scan_encode_blocks over files gives the blocks of the encoder."""
    jax_ingest = _jax_native()
    blocks = [SEQ_BLOCKS["awkward"] + b"\n", SEQ_BLOCKS["baskets"],
              b"T9,a,new1,,new2\n", SEQ_BLOCKS["blank"]]
    vocab, index = [], {}
    j_vocab, j_index = [], {}
    enc = ingest.BlockScanEncoder(",", 1, vocab, index, marker)
    j_enc = jax_ingest.BlockScanEncoder(",", 1, j_vocab, j_index, marker)
    outs = []
    for data in blocks:
        got, want = enc.encode(data), j_enc.encode(data)
        assert (got is None) == (want is None)
        if got is None:
            continue
        outs.append(got)
        for a, b in zip(got, want):
            assert np.asarray(a).tolist() == np.asarray(b).tolist()
        assert vocab == j_vocab
    assert index == {t: i for i, t in enumerate(vocab)}
    assert "" not in vocab and (marker is None) == ("*" in vocab)
    paths = []
    for i, data in enumerate(blocks):
        p = tmp_path / f"b{i}.csv"
        p.write_bytes(data)
        paths.append(str(p))
    scanned = list(ingest.scan_encode_blocks(paths, ",", 1, [], {}, 1 << 20,
                                             marker))
    assert len(scanned) == len(outs)
    for a, b in zip(scanned, outs):
        assert [np.asarray(x).tolist() for x in a] == \
            [np.asarray(x).tolist() for x in b]
