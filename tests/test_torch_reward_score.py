"""The port's rule scorers and offline evaluation on the CPU, against the JAX
package's (host-only Python on both sides: the answers must be equal, not
close).

* every data source of the registry through `default_compute_score` and
  `compute_score_with_info`, on right, wrong and unanswered responses;
* `prime_code`'s `python -I` subprocess sandbox: stdin / stdout and
  call-style programs, a crashing one, and one that runs past its timeout;
* `main_eval.evaluate_parquet` and `run` on a parquet of several sources
  with n responses per row.
"""
import json

import numpy as np
import pytest

from vla_rft_tpu.trainer import main_eval as j_eval
from vla_rft_tpu.utils import reward_score as j_rs
from vla_rft_tpu.utils.reward_score import prime_code as j_code
from vla_rft_tpu_torch.trainer import main_eval as t_eval
from vla_rft_tpu_torch.utils import reward_score as t_rs
from vla_rft_tpu_torch.utils.reward_score import prime_code as t_code

ADD = json.dumps({"inputs": ["1 2\n", "5 7\n"], "outputs": ["3\n", "12\n"]})
CALL = json.dumps({"inputs": [[2, 3], [4, 4]], "outputs": [[6], [16]], "fn_name": "mul"})
PROGRAMS = {
    "passes": "```python\na, b = map(int, input().split())\nprint(a + b)\n```",
    "wrong": "```python\na, b = map(int, input().split())\nprint(a * b)\n```",
    "crashes": "```python\nraise SystemExit(3)\n```",
}
# (solution, ground truth) cases per scorer module: right, wrong, unanswered
CASES = {
    "gsm8k": [("so #### 1,234", "1234"), ("#### 41", "42"), ("no answer", "42")],
    "math": [("so \\boxed{\\frac{1}{2}}", "\\frac{1}{2}"), ("\\boxed{3}", "4"), ("none", "4")],
    "math_dapo": [("The answer is \\boxed{12}", "12"), ("Answer: 7", "8"), ("nothing", "3")],
    "math_verify": [("thus $x = \\frac{2}{4}$, \\boxed{0.5}", "\\frac{1}{2}"),
                    ("\\boxed{2}", "3"), ("no math here", "1")],
    "prime_math": [("\\boxed{\\frac{6}{4}}", "1.5"), ("\\boxed{x^2}", "x^3"), ("blank", "2"),
                   ("so \\boxed{x^2+2x+1}", "(x+1)^2")],  # equal only through sympy
    "gpqa": [("reasoning... Answer: b", "B"), ("Answer: C", "D"), ("unsure", "A")],
    "geo3k": [("\\boxed{3.00001}", "3"), ("\\boxed{4}", "3"), ("3", "3")],
    "prime_code": [(PROGRAMS["passes"], ADD), (PROGRAMS["wrong"], ADD),
                   ("```python\ndef mul(a, b):\n    return a * b\n```", CALL)],
}


@pytest.mark.parametrize("source", sorted(t_rs._REGISTRY))
def test_every_registry_source_scores_as_the_reference(source):
    assert t_rs._REGISTRY == j_rs._REGISTRY
    assert t_rs.has_scorer(source) and j_rs.has_scorer(source)
    for sol, gt in CASES[t_rs._REGISTRY[source]]:
        assert t_rs.default_compute_score(source, sol, gt) == \
            j_rs.default_compute_score(source, sol, gt), (sol, gt)
        assert t_rs.compute_score_with_info(source, sol, gt) == \
            j_rs.compute_score_with_info(source, sol, gt), (sol, gt)
    right = CASES[t_rs._REGISTRY[source]][0]
    assert t_rs.default_compute_score(source, *right) == 1.0


def test_unknown_sources_are_refused():
    for fn in (t_rs.default_compute_score, t_rs.compute_score_with_info):
        with pytest.raises(NotImplementedError):
            fn("no_such_source", "x", "y")
    assert not t_rs.has_scorer("no_such_source")


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("continuous", [False, True])
def test_prime_code_sandbox_matches_the_reference(program, continuous):
    got = t_code.compute_score(PROGRAMS[program], ADD, continuous=continuous)
    ref = j_code.compute_score(PROGRAMS[program], ADD, continuous=continuous)
    assert got == ref
    assert got[0] == (1.0 if program == "passes" else 0.0)


def test_prime_code_timeout_and_bad_cases():
    loop = "```python\nwhile True:\n    pass\n```"
    cases = {"inputs": ["1\n"], "outputs": ["1\n"]}
    got = t_code.check_correctness(cases, t_code.extract_code(loop), timeout=0.5)
    assert got == j_code.check_correctness(cases, j_code.extract_code(loop), timeout=0.5)
    assert got == [False]
    assert t_code._run_one("while True: pass", "", None, 0.5) == (False, "<timeout>")
    for bad in ("not json", json.dumps({"inputs": [], "outputs": []})):
        assert t_code.compute_score(PROGRAMS["passes"], bad) == \
            j_code.compute_score(PROGRAMS["passes"], bad)


def _eval_parquet(path):
    import pandas as pd

    rows = {
        "prompt": ["p0", "p1", "p2", "p3", "p4"],
        "data_source": ["openai/gsm8k", "openai/gsm8k", "lighteval/MATH", "gpqa", "apps"],
        "reward_model": [{"ground_truth": "42"}, {"ground_truth": "7"},
                         {"ground_truth": "\\frac{1}{2}"}, {"ground_truth": "B"},
                         {"ground_truth": ADD}],
        "responses": [np.array(["#### 42", "#### 41", "none"]),
                      np.array(["#### 7", "#### 7", "#### 7"]),
                      np.array(["\\boxed{\\frac{1}{2}}", "\\boxed{1}", "x"]),
                      np.array(["Answer: B", "Answer: A", "Answer: B"]),
                      np.array([PROGRAMS["passes"], PROGRAMS["wrong"], PROGRAMS["crashes"]])],
    }
    pd.DataFrame(rows).to_parquet(path)


def test_evaluate_parquet_and_run_equal_the_reference(tmp_path, capsys):
    path = str(tmp_path / "gen.parquet")
    _eval_parquet(path)
    got, ref = t_eval.evaluate_parquet(path), j_eval.evaluate_parquet(path)
    assert got == ref
    assert got["test_score/openai/gsm8k/best@n"] == 1.0
    assert got["test_score/openai/gsm8k/pass@1"] == pytest.approx((1 / 3 + 1) / 2)
    assert got["test_score/apps/count"] == 1
    assert t_eval.run([f"data.path={path}"]) == ref
    out = capsys.readouterr().out
    assert "test_score/gpqa/pass@1: " in out
    with pytest.raises(SystemExit):
        t_eval.run([])


def test_main_eval_runs_on_the_host_without_cuda(tmp_path, monkeypatch):
    """main_eval has no device: it scores with CUDA absent, where the
    port's device entry points refuse (test_torch_text_generation.py)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "gen.parquet")
    _eval_parquet(path)
    assert t_eval.run([f"data.path={path}"]) == j_eval.evaluate_parquet(path)
