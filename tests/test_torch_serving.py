"""The port's serving path on the CPU: the wire codec against the JAX
package's, an ActionServer round trip with the tiny policy, the resize and
pixel glue against the reference's, and two rules of the port: it never
imports JAX or the JAX package, and its entry points refuse to run on a
machine without CUDA unless the caller asks for the CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vla_rft_tpu.eval import policy as j_policy
from vla_rft_tpu.serving import action_server as j_server
from vla_rft_tpu_torch.eval import policy as t_policy
from vla_rft_tpu_torch.models.factory import build_policy
from vla_rft_tpu_torch.serving import action_server as t_server

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _observation(seed, size=224):
    rng = np.random.default_rng(seed)
    return {
        "full_image": rng.integers(0, 256, (size, size, 3), dtype=np.uint8),
        "proprio": rng.normal(size=8).astype(np.float32),
    }


def test_payload_codec_matches_jax_package_byte_for_byte():
    obs = _observation(0, size=16)
    payload = {
        "instruction": "put the bowl on the plate",
        **obs,
        "extra": [np.float64(1.5), np.int32(3), {"wrist_image": np.zeros((2, 2, 3), np.uint8)}],
    }
    wire = t_server.encode_payload(payload)
    assert wire == j_server.encode_payload(payload)
    for decoded in (t_server.decode_payload(wire), j_server.decode_payload(wire)):
        np.testing.assert_array_equal(decoded["full_image"], obs["full_image"])
        assert decoded["full_image"].dtype == np.uint8
    double = b'{"encoded": ' + __import__("json").dumps(wire.decode()).encode() + b"}"
    np.testing.assert_array_equal(
        t_server.decode_payload(double)["proprio"], j_server.decode_payload(double)["proprio"]
    )


def test_action_server_round_trip_with_tiny_policy():
    policy_fn = t_policy.build_policy_fn(preset="tiny", device="cpu", seed=3)
    server = t_server.ActionServer(policy_fn, host="127.0.0.1", port=0)
    server.start_background()
    try:
        url = f"http://127.0.0.1:{server.port}/act"
        actions = [
            t_server.get_action_from_server(
                {"instruction": "open the drawer", **_observation(i)}, url, timeout=60
            )
            for i in range(2)
        ]
    finally:
        server.shutdown()
    for a in actions:
        assert a.shape == (8, 7) and np.isfinite(a).all()
        assert set(np.unique(a[:, -1])) <= {-1.0, 0.0, 1.0}  # binarized, inverted gripper
    # same seed, same request -> same chunk (the tokenizer stub is unsalted)
    again = t_policy.build_policy_fn(preset="tiny", device="cpu", seed=3)
    np.testing.assert_array_equal(again(_observation(0), "open the drawer"), actions[0])


def test_bad_request_is_400():
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    server = t_server.ActionServer(lambda obs, instr: np.zeros((8, 7)), host="127.0.0.1", port=0)
    server.start_background()
    try:
        req = Request(f"http://127.0.0.1:{server.port}/act", data=b'{"no_instruction": 1}')
        with pytest.raises(HTTPError) as err:
            urlopen(req, timeout=10)
        assert err.value.code == 400
    finally:
        server.shutdown()


def test_stub_tokenizer_is_stable_across_processes():
    code = (
        "from vla_rft_tpu_torch.eval.policy import _StubTokenizer;"
        "print(_StubTokenizer().encode('pick up the black bowl'))"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE, text=True, cwd=ROOT,
            env={**os.environ, "PYTHONHASHSEED": seed},
        )
        for seed in ("1", "2")
    ]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1] != ""


@pytest.mark.parametrize("src", [40, 20], ids=["downscale", "upscale"])
def test_fit_views_matches_jax_image_resize(src):
    six = np.random.default_rng(src).uniform(size=(src, src, 6)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(six), (28, 28, 6), "bilinear"))
    np.testing.assert_allclose(t_policy.fit_views(six, 28), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("center_crop", [False, True])
def test_assemble_pixels_matches_reference(center_crop):
    obs = _observation(4, size=32)
    obs["wrist_image"] = _observation(5, size=32)["full_image"]
    for n in (1, 2):
        np.testing.assert_array_equal(
            t_policy.assemble_pixels(obs, n, center_crop),
            j_policy.assemble_pixels(obs, n, center_crop),
        )


# --------------------------------------------------------------- port rules
_FORBIDDEN = re.compile(r"^(jax|flax|vla_rft_tpu|tools)(\.|$)")
_FORBIDDEN_STR = re.compile(r"""(import_module|__import__)\(\s*["'](jax|flax|vla_rft_tpu|tools)["'.]""")


def _port_sources():
    files = sorted((ROOT / "vla_rft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_port_never_imports_jax_or_the_jax_package():
    hits = []
    for path in _port_sources():
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            hits += [f"{path.name}: {n}" for n in names if _FORBIDDEN.match(n)]
        hits += [f"{path.name}: {m.group(0)}" for m in _FORBIDDEN_STR.finditer(text)]
    assert not hits, hits


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_policy("tiny")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_policy.build_policy_fn(preset="tiny")
