"""PRIME code scorer: run generated Python against APPS-style test cases in
a sandboxed subprocess (verl/utils/reward_score/prime_code/ parity:
__init__.py compute_score + utils.check_correctness semantics, rebuilt on
subprocess instead of multiprocessing.Manager).

Test-case format (ground_truth, JSON or dict):
  {"inputs": [...], "outputs": [...]}            stdin/stdout programs
  {"inputs": [[args]...], "outputs": [ret...],   call-style problems
   "fn_name": "solve"}

Scoring (reference __init__.py:21-76): extract the last ```python fenced
block; run ALL cases first — full pass returns 1.0 immediately; otherwise
with continuous=True the score is the pass fraction over the first
min(10, N) per-case runs, else 0.0.  Every execution happens in a separate
`python -I` subprocess with a hard timeout, its own process group, and no
inherited globals — a syscall-level sandbox is out of scope here exactly as
it is in the reference (which also executes in a forked CPython).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Tuple

_TIMEOUT_S = 5.0

_FN_DRIVER = r"""
import json, os, sys
_payload = json.loads(sys.stdin.read())
_args = _payload["args"]
# python -I keeps the script dir off sys.path; exec the solution explicitly
_ns = {"__name__": "solution"}
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "solution.py")) as _f:
    exec(compile(_f.read(), "solution.py", "exec"), _ns)
_fn = _ns[_payload["fn_name"]]
_res = _fn(*_args)
print(json.dumps(_res))
"""


def extract_code(completion: str) -> str:
    """Last ```python fenced block, or the raw completion if none."""
    return completion.split("```python")[-1].split("```")[0]


def _run_one(
    code: str, inp: Any, fn_name: str | None, timeout: float
) -> Tuple[bool, str]:
    """Run one test case in an isolated subprocess. Returns (ok, stdout)."""
    with tempfile.TemporaryDirectory() as d:
        env = {"PATH": os.environ.get("PATH", ""), "PYTHONHASHSEED": "0"}
        if fn_name is None:
            path = os.path.join(d, "main.py")
            with open(path, "w") as f:
                f.write(code)
            stdin = inp if isinstance(inp, str) else "\n".join(map(str, inp))
            cmd = [sys.executable, "-I", path]
        else:
            with open(os.path.join(d, "solution.py"), "w") as f:
                f.write(code)
            path = os.path.join(d, "driver.py")
            with open(path, "w") as f:
                f.write(_FN_DRIVER)
            args = inp if isinstance(inp, list) else [inp]
            stdin = json.dumps({"args": args, "fn_name": fn_name})
            cmd = [sys.executable, "-I", path]
        try:
            proc = subprocess.run(
                cmd,
                input=stdin,
                capture_output=True,
                text=True,
                timeout=timeout,
                cwd=d,
                env=env,
                start_new_session=True,  # its own process group: clean kill
            )
        except subprocess.TimeoutExpired:
            return False, "<timeout>"
        except Exception as e:  # pragma: no cover - spawn failure
            return False, f"<spawn error: {e}>"
        if proc.returncode != 0:
            return False, proc.stderr[-500:]
        return True, proc.stdout


def _outputs_match(got: str, expected: Any, fn_name: str | None) -> bool:
    if fn_name is not None:
        try:
            got_val = json.loads(got.strip() or "null")
        except json.JSONDecodeError:
            return False
        exp = expected
        if isinstance(exp, list) and len(exp) == 1 and not isinstance(got_val, list):
            exp = exp[0]  # APPS wraps scalar returns in a list
        return got_val == exp
    exp_str = expected if isinstance(expected, str) else "\n".join(map(str, expected))
    got_lines = [l.strip() for l in got.strip().splitlines()]
    exp_lines = [l.strip() for l in exp_str.strip().splitlines()]
    return got_lines == exp_lines


def check_correctness(
    in_outs: Dict[str, Any],
    generation: str,
    timeout: float = _TIMEOUT_S,
    stop_after: int | None = None,
) -> List[bool]:
    """Run the cases in order; result[i] = case i passed (utils.
    check_correctness role, minus the manager/fork plumbing).

    stop_after bounds the wall-clock of a failing generation: once a failure
    is known AND at least `stop_after` cases have run, the remaining cases
    are skipped (the reference caps its per-case loop at 10 for the same
    reason — 'do not test all samples cuz some problems have enormous test
    cases', prime_code/__init__.py:50).  A fully-passing generation still
    runs every case, which the full-pass score requires."""
    fn_name = in_outs.get("fn_name")
    results: List[bool] = []
    failed = False
    for inp, out in zip(in_outs["inputs"], in_outs["outputs"]):
        ok, got = _run_one(generation, inp, fn_name, timeout)
        results.append(bool(ok and _outputs_match(got, out, fn_name)))
        failed = failed or not results[-1]
        if failed and stop_after is not None and len(results) >= stop_after:
            break
    return results


def compute_score(
    completion: str, test_cases, continuous: bool = False
) -> Tuple[float, Dict[str, Any]]:
    """Returns (score, metadata). Mirrors prime_code.compute_score
    (__init__.py:21-76, continuous defaults False there too): 1.0 on full
    pass; else pass-fraction over the first min(10, N) cases when continuous,
    else 0.0.  A failing run stops after the scored prefix instead of paying
    N subprocess timeouts."""
    solution = extract_code(completion)
    try:
        if not isinstance(test_cases, dict):
            test_cases = json.loads(test_cases)
    except Exception as e:
        return 0.0, {"error": f"bad test cases: {e}"}
    if not test_cases.get("inputs"):
        return 0.0, {"error": "no test cases"}
    total = len(test_cases["inputs"])
    try:
        results = check_correctness(
            test_cases, solution, stop_after=10 if continuous else 1
        )
    except Exception as e:
        return 0.0, {"error": f"execution failed: {e}"}
    if len(results) == total and all(results):
        return 1.0, {"passed": total, "total": total}
    if not continuous:
        return 0.0, {"passed": sum(results), "total": total}
    head = results[: min(10, total)]
    return sum(head) / len(head), {"passed": sum(results), "total": total}
