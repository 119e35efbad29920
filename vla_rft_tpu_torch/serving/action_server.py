"""VLA action server: serve the policy to robot clients over HTTP.

Port of vla_rft_tpu/serving/action_server.py (the counterpart of the
reference's vla-scripts/deploy.py: POST /act), with the same wire format:
numpy arrays ride as {"__ndarray__": <b64>, "dtype", "shape"} JSON tags, the
double-encoded {"encoded": <json string>} form is accepted, and a bad
request gets a 400 with the deploy.py hint.  The policy stays resident on
the GPU; requests are served by a threaded stdlib HTTP server and the policy
calls run one at a time under a lock.

Protocol (POST /act):
  request  {"instruction": str, "full_image": ndarray-tag, ...any obs keys}
  response ndarray-tag of the (chunk, action_dim) action chunk
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict

import numpy as np


def _encode_value(v):
    if isinstance(v, np.ndarray):
        return {
            "__ndarray__": base64.b64encode(np.ascontiguousarray(v).tobytes()).decode(),
            "dtype": str(v.dtype),
            "shape": list(v.shape),
        }
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_encode_value(x) for x in v]
    return v


def _decode_value(v):
    if isinstance(v, dict):
        if "__ndarray__" in v:
            raw = base64.b64decode(v["__ndarray__"])
            return np.frombuffer(raw, dtype=np.dtype(v["dtype"])).reshape(v["shape"]).copy()
        return {k: _decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x) for x in v]
    return v


def encode_payload(obj: Any) -> bytes:
    """Serialize a dict/array tree with ndarray tags (json_numpy analog)."""
    return json.dumps(_encode_value(obj)).encode()


def decode_payload(data: bytes) -> Any:
    """Inverse of encode_payload; also unwraps the double-encoded form
    (deploy.py:81-84: {"encoded": "<json string>"})."""
    obj = json.loads(data.decode())
    if isinstance(obj, dict) and set(obj.keys()) == {"encoded"}:
        obj = json.loads(obj["encoded"])
    return _decode_value(obj)


_BAD_REQUEST_MSG = (
    "Your request threw an error; make sure your request complies with the "
    "expected format:\n{'instruction': str, <observation keys>: ndarray tags}\n"
)


class ActionServer:
    """Serves `policy_fn(observation: dict, instruction: str) -> np.ndarray`
    at POST /act (deploy.py's OpenVLAServer).  The policy_fn is injected, so
    the same server wraps the flow-matching VLA (eval/policy.build_policy_fn)
    or a scripted policy in tests.
    """

    def __init__(self, policy_fn: Callable[[Dict[str, Any], str], np.ndarray],
                 host: str = "0.0.0.0", port: int = 8777):
        self.policy_fn = policy_fn
        self._lock = threading.Lock()  # one policy call at a time
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def do_POST(self):
                if self.path.rstrip("/") != "/act":
                    self.send_error(404)
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = decode_payload(self.rfile.read(n))
                    instruction = payload.pop("instruction")
                    with outer._lock:
                        action = np.asarray(outer.policy_fn(payload, instruction))
                    body = encode_payload(action)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception as e:  # noqa: BLE001 — mirror deploy.py:99-104
                    body = json.dumps({"error": f"{e}", "hint": _BAD_REQUEST_MSG}).encode()
                    self.send_response(400)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._server.server_address[1]  # resolved if port=0

    def serve_forever(self):
        """Blocking run (deploy.py:120-123 uvicorn.run analog)."""
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


def get_action_from_server(observation: Dict[str, Any], endpoint: str,
                           timeout: float = 60.0) -> np.ndarray:
    """Client half (openvla_utils.get_action_from_server): POST the
    observation (instruction included) to `endpoint`, return the decoded
    action chunk.  stdlib urllib: the robot side needs nothing beyond numpy."""
    from urllib.request import Request, urlopen

    req = Request(endpoint, data=encode_payload(observation),
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=timeout) as resp:
        return np.asarray(decode_payload(resp.read()))


def main(argv=None):
    """CLI: serve the flow-matching VLA policy (deploy.py's draccus main).

    python -m vla_rft_tpu_torch.serving.action_server --ckpt <dir> --port 8777
    """
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default="",
                   help="directory read for dataset_statistics.json (action un-normalisation) "
                        "and a tokenizer; the weights stay seeded random, as in the reference")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--num_flow_steps", type=int, default=10)
    p.add_argument("--num_images_in_input", type=int, default=1)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from vla_rft_tpu_torch.eval.policy import build_policy_fn

    policy_fn = build_policy_fn(
        ckpt=args.ckpt, num_flow_steps=args.num_flow_steps,
        num_images=args.num_images_in_input, center_crop=args.center_crop,
        device=args.device,
    )
    server = ActionServer(policy_fn, host=args.host, port=args.port)
    print(f"[action_server] serving /act on {args.host}:{server.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
