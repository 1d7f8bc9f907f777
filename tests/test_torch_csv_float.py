"""The port's CSV float reader against pandas.read_csv's default one.

pandas' C parser converts float fields with precise_xstrtod, which is not
correctly rounded (17 significant digits, leading zeros counted; up to
~1e-13 relative).  The JAX package reads the omics CSVs with pandas'
defaults, so the port's native.parse_csv_floats reproduces that converter,
and read_omics_csv pandas' column typing around it.  Required: equal bits
(NaN where pandas gives NaN), on hand-picked and hypothesis-drawn strings
(17+ digits, leading zeros, exponents, signs, whitespace, NA strings,
infinities), and on a whole omics CSV.
"""
import io

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from multilevel_gnn_tpu_torch.data import native
from multilevel_gnn_tpu_torch.data.loaders import read_omics_csv

HAND = [
    "0.1", "1.2345678901234567890", "0.000123456789012345678", "-0.0", "+1.5",
    "1e5", "1E-5", "1.5e+300", "1e-320", "  3.25  ", "\t-2.5", "123", "-007",
    "12345678901234567890123", "9007199254740993", ".5", "5.", "0.30000000000000004441",
    "1.7976931348623157e308", "4.9e-324", "0.1e-310", "123456.78901234567890123",
    "0000000000000000001.5", "0.00000000000000000000000012345678901234567",
    "98765432109876543210.123e-10", "1e309", "-1e309", "0e309", "-0e400",
    "0.00000000000000001e325", "9.9e308", "1e-00000000000000000000005",
    "1e4294967296", "-1e-616", "-1e-700", "NA", "", "nan", "NaN", "-nan", "N/A", "NULL",
    "#N/A", "None", "<NA>", "n/a", "null", "inf", "-inf", "+Infinity", "-INFINITY",
]


def _pandas(fields):
    """pandas' default converter on one float column of these fields (a
    second column keeps an empty field from making a blank line)."""
    text = "x,y\n" + "".join(f"{f},0\n" for f in fields)
    return pd.read_csv(io.StringIO(text), dtype=np.float64)["x"].to_numpy()


def _same_bits(a, b):
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and np.array_equal(
        a[~na].view(np.uint64), b[~nb].view(np.uint64))


def test_hand_picked_fields_equal_pandas():
    values, _, _ = native.parse_csv_floats(HAND)
    assert _same_bits(values, _pandas(HAND))


@st.composite
def _numbers(draw):
    digits = st.text(alphabet="0123456789", max_size=26)
    ip, fp = draw(digits), draw(st.one_of(st.none(), digits))
    if not ip and not fp:
        ip = "0"
    s = draw(st.sampled_from(["", "-", "+"])) + ip + ("" if fp is None else "." + fp)
    if draw(st.booleans()):
        s += (draw(st.sampled_from("eE")) + draw(st.sampled_from(["", "-", "+"]))
              + draw(st.sampled_from(["", "0", "000"]))
              + str(draw(st.one_of(st.integers(0, 700), st.integers(0, 10**12)))))
    pad = st.sampled_from(["", " ", "  "])
    return draw(pad) + s + draw(pad)


@st.composite
def _formatted(draw):
    x = draw(st.floats(allow_nan=False, allow_infinity=False))
    return draw(st.sampled_from(["{!r}", "{:.17e}", "{:.20e}", "{:.17g}", "{:.25f}",
                                 "{:.6f}"])).format(x)


_FIELDS = st.lists(st.one_of(_numbers(), _formatted(),
                             st.sampled_from(["NA", "", "nan", "null", "inf", "-Infinity"])),
                   min_size=1, max_size=12)


@settings(max_examples=300, deadline=None, database=None)
@given(_FIELDS)
def test_drawn_fields_equal_pandas(fields):
    try:
        ref = _pandas(fields)
    except ValueError:  # pandas cannot read the column as floats
        with pytest.raises(ValueError):
            native.parse_csv_floats(fields)
        return
    values, _, _ = native.parse_csv_floats(fields)
    assert _same_bits(values, ref), list(zip(fields, values, ref))


def test_many_digits_differ_from_correct_rounding():
    """On random 17-25 digit strings pandas' converter and so the port's
    differ from Python's float() in many fields, and agree with each other
    in all."""
    rng = np.random.RandomState(0)
    x = rng.randn(5000) * 10.0 ** rng.randint(-8, 8, 5000)
    fields = [f"{v:.22e}" if i % 2 else f"{v:.25f}" for i, v in enumerate(x)]
    values, _, _ = native.parse_csv_floats(fields)
    assert _same_bits(values, _pandas(fields))
    assert (values != np.array([float(f) for f in fields])).sum() > 100


@pytest.mark.parametrize("bad", ["1_000", ".", "-", "e5", "1e", "1e+", "1.5x", " ",
                                 "1 5", "0x10", "1.5e3.2", "NAN"])
def test_unparseable_field_raises(bad):
    """What pandas reads into a string column, the port refuses."""
    with pytest.raises(ValueError, match="could not convert"):
        native.parse_csv_floats(["1.5", bad])
    assert str(pd.read_csv(io.StringIO(f"x,y\n1.5,0\n{bad},0\n"))["x"].dtype) != "float64"


def test_omics_csv_equals_pandas_read_csv(tmp_path):
    """A whole omics CSV: int64 columns (read exactly, as pandas' int
    column is: 18-digit integers past 2^53 included, and with an NA among
    them), long decimals, NA strings; values, index and columns as pandas
    gives them."""
    rng = np.random.RandomState(3)
    n = 40
    cols = {
        "101": [str(v) for v in rng.randint(-10**6, 10**6, n)],
        "102": ["9007199254740993", "-9223372036854775808"]
        + [str(v) for v in rng.randint(0, 10**17, n - 2)],
        "103": ["NA"] + ["12345678901234567" + str(i) for i in range(n - 1)],
        "106": ["12345678901234567" + str(i) for i in range(n - 1)] + ["0.5"],
        "104": [f"{v:.24f}" for v in rng.randn(n) * 1e-3],
        "105": [["", "nan", "NULL", repr(float(v))][i % 4] for i, v in enumerate(rng.randn(n))],
    }
    path = tmp_path / "omics.csv"
    lines = ["," + ",".join(cols)]
    lines += [f"TCGA-{i:02d}," + ",".join(c[i] for c in cols.values()) for i in range(n)]
    path.write_text("\n".join(lines) + "\n")
    port = read_omics_csv(str(path))
    ref = pd.read_csv(path, index_col=0)
    assert port.index == list(ref.index) and port.columns == list(ref.columns)
    assert str(ref["102"].dtype) == "int64" and str(ref["103"].dtype) == "float64"
    assert _same_bits(port.values.ravel(), ref.to_numpy(np.float64).ravel())
