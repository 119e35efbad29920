"""PRIME math answer grader (sympy-based equivalence).

Role parity with the reference's prime_math package
(train/verl/verl/utils/reward_score/prime_math/{__init__,grader,
math_normalize}.py, ~1000 LoC): extract the final answer from a model
response (boxed latex or "answer is" markers), normalize away latex/unit
decoration, and grade against the ground truth with a tiered equivalence
check — normalized string match, numeric closeness, then sympy symbolic
equality under a hard timeout.  This is a from-scratch compact
implementation (the reference vendors OpenAI's prm800k grader + ToRA; we
implement the same contract natively so the TPU build carries no torch/GPU
dependency and no pylatexenc requirement).

compute_score returns the reference's tuple contract
(prime_math/__init__.py:408-430): (is_correct, format_correctness,
extracted_answer).
"""
from __future__ import annotations

import math
import re
import signal
from typing import Optional, Tuple

# --------------------------------------------------------------- extraction


def last_boxed_content(text: str) -> Optional[str]:
    """Content of the last \\boxed{...} / \\fbox{...}, brace-balanced."""
    idx = max(text.rfind("\\boxed"), text.rfind("\\fbox"))
    if idx < 0:
        return None
    depth, start = 0, None
    for i in range(idx, len(text)):
        c = text[i]
        if c == "{":
            depth += 1
            if start is None:
                start = i + 1
        elif c == "}":
            depth -= 1
            if depth == 0 and start is not None:
                return text[start:i].strip()
    return None


_TAIL_MARKERS = ("answer:", "answer is", "answers are")
_HEAD_MARKERS = ("is answer", "is the answer", "are answers", "are the answers")
_EQ_MARKERS = ("be ", "is ", "are ", "=", ": ", "get ", "be\n", "is\n", "are\n", ":\n", "get\n")


def match_answer(response: str) -> Tuple[bool, str]:
    """Locate the final answer substring (prime_math/__init__.py:363-403
    semantics): keep text after 'answer is'-style markers, before
    'is the answer'-style markers, prefer the last boxed expression, trim a
    trailing sentence, and require at least one digit."""
    matched = False
    for m in _TAIL_MARKERS:
        i = response.lower().rfind(m)
        if i != -1:
            matched = True
            response = response[i + len(m):].strip()
    for m in _HEAD_MARKERS:
        i = response.lower().rfind(m)
        if i != -1:
            matched = True
            response = response[:i].strip()
    boxed = last_boxed_content(response)
    if boxed is not None:
        matched = True
        response = boxed
    dot = response.lower().rfind(". ")
    if dot != -1:
        response = response[:dot].strip()
    for m in _EQ_MARKERS:
        i = response.lower().rfind(m)
        if i != -1:
            matched = True
            response = response[i + len(m):].strip()
    if not any(c.isdigit() for c in response):
        matched = False
    return matched, response


# ------------------------------------------------------------ normalization

_UNIT_WORDS = (
    "degrees?|cm|centimeters?|meters?|miles?|inches?|feet|foot|hours?|minutes?"
    "|seconds?|units?|dollars?|cents?|pounds?|points?|square|cubic|km|mm|grams?|kg"
)


def normalize_answer(ans: Optional[str]) -> Optional[str]:
    """Canonical string form: latex decoration, units, currency, thousands
    separators, and wrapper braces removed; \\frac{a}{b} -> (a)/(b);
    \\sqrt{x} -> sqrt(x); mixed number '1 3/4' -> '1+3/4'."""
    if ans is None:
        return None
    s = ans.strip()
    # strip \text{...} / \mbox{...} wrappers and $ signs
    s = re.sub(r"\\(?:text|mbox|textbf|mathrm)\s*\{([^{}]*)\}", r"\1", s)
    s = s.replace("$", "").replace("\\$", "").replace("%", "").replace("\\%", "")
    s = s.replace("\\!", "").replace("\\,", " ").replace("\\ ", " ")
    s = s.replace("\\left", "").replace("\\right", "")
    s = re.sub(r"\\(?:d|t)frac", r"\\frac", s)
    # \frac{a}{b} -> (a)/(b) ; \frac12 -> (1)/(2)
    for _ in range(4):
        s = re.sub(r"\\frac\s*\{([^{}]+)\}\s*\{([^{}]+)\}", r"(\1)/(\2)", s)
        s = re.sub(r"\\frac\s*(\d)\s*(\d)", r"(\1)/(\2)", s)
        s = re.sub(r"\\frac\s*\{([^{}]+)\}\s*(\d)", r"(\1)/(\2)", s)
    s = re.sub(r"\\sqrt\s*\{([^{}]+)\}", r"sqrt(\1)", s)
    s = re.sub(r"\\sqrt\s*(\d)", r"sqrt(\1)", s)
    s = s.replace("\\pi", "pi").replace("\\cdot", "*").replace("\\times", "*")
    s = s.replace("\\infty", "oo").replace("\\div", "/")
    s = re.sub(rf"\b(?:{_UNIT_WORDS})\b\.?\s*(?:\^\s*\d)?", "", s)
    s = s.replace("{,}", "")  # latex thousands separator
    # thousands separators in plain numbers (not tuples): 1,234,567
    s = re.sub(r"(\d),(?=\d{3}(\D|$))", r"\1", s)
    # mixed number: 1 3/4 -> (1+3/4)
    s = re.sub(r"^(-?\d+)\s+(\d+)\s*/\s*(\d+)$", r"(\1+\2/\3)", s.strip())
    s = s.replace("{", "").replace("}", "").strip()
    # leading-zero decimals: .5 -> 0.5
    s = re.sub(r"(^|[^\d])\.(\d)", r"\g<1>0.\2", s)
    # x = 5 -> 5 (keep RHS of a simple final equation)
    m = re.match(r"^[a-zA-Z]\s*=\s*(.+)$", s)
    if m:
        s = m.group(1).strip()
    if s.endswith("."):
        s = s[:-1]
    return s.lower().strip()


# ----------------------------------------------------------------- grading


class _Timeout:
    """Hard wall-clock bound on sympy work (sympy can hang on adversarial
    inputs; the reference uses the same SIGALRM discipline,
    prime_math/__init__.py:37-62)."""

    def __init__(self, seconds: int):
        self.seconds = seconds

    def __enter__(self):
        if hasattr(signal, "SIGALRM"):
            self._old = signal.signal(signal.SIGALRM, self._raise)
            signal.alarm(self.seconds)
        return self

    @staticmethod
    def _raise(signum, frame):
        raise TimeoutError

    def __exit__(self, *exc):
        if hasattr(signal, "SIGALRM"):
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._old)
        return False


def _to_float(s: str) -> Optional[float]:
    try:
        return float(s.replace(",", "").replace(" ", ""))
    except (ValueError, AttributeError):
        return None


_SYMPY_UNSAFE = re.compile(r"\^\s*[{(]|\^\d{2,}|\\")  # nested powers / leftover latex


def _sympy_equal(a: str, b: str, pi_val: Optional[float] = None, timeout_s: int = 6) -> bool:
    if _SYMPY_UNSAFE.search(a) or _SYMPY_UNSAFE.search(b):
        return False
    try:
        import sympy
        from sympy.parsing import sympy_parser

        def parse(s):
            s = s.replace("^", "**")
            if pi_val is not None:
                # (?<![a-z]) not \b: '2pi' has no word boundary after the digit
                s = re.sub(r"(?<![a-zA-Z])pi(?![a-zA-Z])", f"({pi_val})", s)
            return sympy_parser.parse_expr(
                s,
                transformations=sympy_parser.standard_transformations
                + (sympy_parser.implicit_multiplication_application,),
            )

        with _Timeout(timeout_s):
            ea, eb = parse(a), parse(b)
            if ea == eb:
                return True
            diff = sympy.simplify(ea - eb)
            if diff == 0:
                return True
            # numeric fallback for expressions simplify can't close
            return bool(abs(complex(sympy.N(diff))) < 1e-8)
    except Exception:
        return False


def _split_tuple(s: str) -> Optional[list]:
    if len(s) >= 2 and s[0] in "([" and s[-1] in ")]" and "," in s[1:-1]:
        parts = [p.strip() for p in s[1:-1].split(",")]
        if all(parts):
            return parts
    return None


def grade_answer(given: Optional[str], ground_truth: str) -> bool:
    """Tiered equivalence: normalized strings -> floats -> element-wise
    tuples -> sympy (with pi substitution variants when 'pi' appears)."""
    if given is None:
        return False
    ng, nt = normalize_answer(given), normalize_answer(ground_truth)
    if ng is None or nt is None or ng == "" :
        return False
    if ng == nt:
        return True
    fg, ft = _to_float(ng), _to_float(nt)
    if fg is not None and ft is not None:
        return math.isclose(fg, ft, rel_tol=1e-4, abs_tol=1e-8)
    # one side numeric, other symbolic (e.g. "0.5" vs "1/2", "3.14" vs "pi")
    tg, tt = _split_tuple(ng), _split_tuple(nt)
    if tg is not None and tt is not None:
        if len(tg) != len(tt):
            return False
        return all(grade_answer(a, b) for a, b in zip(tg, tt))
    if (tg is None) != (tt is None):
        return False
    if "pi" in ng or "pi" in nt:
        return any(_sympy_equal(ng, nt, pi_val=pv) for pv in (None, math.pi, 3.14))
    return _sympy_equal(ng, nt)


def compute_score(model_output: str, ground_truth: str):
    """Reference tuple contract (prime_math/__init__.py:408-430):
    (is_correct, format_correctness, extracted_answer)."""
    model_output = str(model_output)
    ground_truth = str(ground_truth)
    matched, extracted = match_answer(model_output)
    format_ok = "Step 2:" in model_output and "\\box" in model_output
    correct = matched and grade_answer(extracted, ground_truth)
    return correct, format_ok, extracted
