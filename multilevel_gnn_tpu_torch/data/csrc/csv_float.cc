// Numeric CSV fields read as pandas.read_csv reads them by default.
//
// pandas' C parser converts a float column with precise_xstrtod (its
// float_precision=None / "high" converter).  That converter is not
// correctly rounded: it gathers at most 17 significant digits into a
// double, leading zeros counted among the 17, by number = number * 10 +
// digit, and then applies the decimal exponent with one multiplication or
// division by a power of ten from a table of doubles.  Some values come
// out up to ~1e-13 relative away from the correctly rounded ones (what
// strtod or Python's float give).  The JAX package reads the omics CSVs
// with pandas' defaults, so the port reads them with this function to
// start from the same bits.  Build with -ffp-contract=off: a fused
// multiply-add would round number * 10 + digit once instead of twice.
//
// A field that is one of pandas' default NA strings reads NaN.  A field
// that does not parse (with or without surrounding whitespace) is an
// error, except the infinities pandas accepts after a failed parse: inf,
// infinity with an optional sign, in any case.

#include <math.h>
#include <stdlib.h>
#include <string.h>
#include <strings.h>

#include <cstdio>

namespace {

double POW10[309];

struct Pow10Init {
  Pow10Init() {
    char buf[16];
    for (int i = 0; i <= 308; ++i) {
      std::snprintf(buf, sizeof buf, "1e%d", i);
      POW10[i] = strtod(buf, nullptr);  // correctly rounded, as a literal
    }
  }
} pow10_init;

const char* const NA[] = {
    "",      "#N/A", "#N/A N/A", "#NA",  "-1.#IND", "-1.#QNAN", "-NaN",
    "-nan",  "1.#IND", "1.#QNAN", "<NA>", "N/A",     "NA",       "NULL",
    "NaN",   "None", "n/a",      "nan",  "null"};

bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

bool is_digit(char c) { return c >= '0' && c <= '9'; }

// pandas' precise_xstrtod with decimal '.', sci 'E', no thousands
// separator, skip_trailing on, as pandas 3.0 reads: an exponent's digits
// are all consumed, a value past the double range reads +-inf (0 for a
// zero mantissa), one below 1e-616 reads 0.  Returns false where there is
// no digit; *end is the first character not consumed.
bool precise_xstrtod(const char* str, double* value, const char** end,
                     bool* maybe_int) {
  const int max_digits = 17;
  const char* p = str;
  *maybe_int = true;
  while (is_space(*p)) ++p;
  bool negative = false;
  if (*p == '-') {
    negative = true;
    ++p;
  } else if (*p == '+') {
    ++p;
  }
  double number = 0.;
  int exponent = 0;
  int num_digits = 0;
  int num_decimals = 0;
  while (is_digit(*p)) {
    if (num_digits < max_digits) {
      number = number * 10. + (*p - '0');
      ++num_digits;
    } else {
      ++exponent;
    }
    ++p;
  }
  if (*p == '.') {
    *maybe_int = false;
    ++p;
    while (num_digits < max_digits && is_digit(*p)) {
      number = number * 10. + (*p - '0');
      ++p;
      ++num_digits;
      ++num_decimals;
    }
    if (num_digits >= max_digits)
      while (is_digit(*p)) ++p;
    exponent -= num_decimals;
  }
  if (num_digits == 0) return false;
  if (negative) number = -number;
  if (*p == 'e' || *p == 'E') {
    *maybe_int = false;
    bool neg_exp = false;
    ++p;
    if (*p == '-') {
      neg_exp = true;
      ++p;
    } else if (*p == '+') {
      ++p;
    }
    int n = 0;
    num_digits = 0;
    while (is_digit(*p)) {  // every digit, the value held at 10^6
      n = n < 100000 ? n * 10 + (*p - '0') : 1000000;
      ++num_digits;
      ++p;
    }
    exponent += neg_exp ? -n : n;
    if (num_digits == 0) --p;  // un-consume the 'e' (or the sign after it)
  }
  if (exponent > 308) {
    number = number == 0. ? 0. : (number < 0. ? -HUGE_VAL : HUGE_VAL);
  } else if (exponent > 0) {
    number *= POW10[exponent];
  } else if (exponent < -308) {  // subnormal
    if (exponent < -616) {
      number = 0.;
    } else {
      number /= POW10[-308 - exponent];
      number /= POW10[308];
    }
  } else {
    number /= POW10[-exponent];
  }
  while (is_space(*p)) ++p;
  *end = p;
  *value = number;
  return true;
}

// An optional sign and digits only, with optional surrounding whitespace,
// inside int64: pandas reads a column of such fields (NA strings allowed)
// as int64, exactly, then as float64 with NaN where a field was NA.  Its
// value goes to *out.
bool int64_like(const char* s, long long* out) {
  while (is_space(*s)) ++s;
  const bool negative = *s == '-';
  if (*s == '+' || *s == '-') ++s;
  unsigned long long v = 0;
  int digits = 0;
  while (is_digit(*s)) {
    if (v > 922337203685477580ULL) return false;  // the next digit overflows
    v = v * 10 + (*s - '0');
    ++digits;
    ++s;
  }
  while (is_space(*s)) ++s;
  if (*s != '\0' || digits == 0) return false;
  if (v > 9223372036854775807ULL + (negative ? 1 : 0)) return false;
  *out = negative ? (long long)(0ULL - v) : (long long)v;
  return true;
}

}  // namespace

// Parses n NUL-terminated fields laid end to end in buf.  out[i] gets the
// value (NaN for an NA string); kind[i] is 0 for a float, 1 for an integer
// within int64 (ival[i] holds it), 2 for an NA string.  Returns -1, or the
// index of the first field that does not parse.
extern "C" long parse_csv_floats(const char* buf, long n, double* out,
                                 unsigned char* kind, long long* ival) {
  const char* s = buf;
  for (long i = 0; i < n; ++i) {
    const size_t len = strlen(s);
    bool na = false;
    for (const char* v : NA) na = na || strcmp(s, v) == 0;
    kind[i] = na ? 2 : 0;
    if (na) {
      out[i] = NAN;
    } else {
      double v;
      const char* end;
      bool maybe_int;
      if (precise_xstrtod(s, &v, &end, &maybe_int) && *end == '\0') {
        out[i] = v;
        kind[i] = maybe_int && int64_like(s, &ival[i]);
      } else if (!strcasecmp(s, "inf") || !strcasecmp(s, "+inf") ||
                 !strcasecmp(s, "infinity") || !strcasecmp(s, "+infinity")) {
        out[i] = HUGE_VAL;
      } else if (!strcasecmp(s, "-inf") || !strcasecmp(s, "-infinity")) {
        out[i] = -HUGE_VAL;
      } else {
        return i;
      }
    }
    s += len + 1;
  }
  return -1;
}
