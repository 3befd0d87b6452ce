"""The port's serving CLI (pgica_tpu_torch/scripts/serve.py) on the CPU, tiny presets.

Both schedulers answer with the captions ``generate_captions`` gives for the
same images (the batch scheduler pads a bucket, the continuous one decodes
through the slot-pool engine); the HTTP handler on 127.0.0.1 answers
``/healthz``, a JSON ``/caption``, a JPEG ``/caption`` and a 400 for a bad
body; ``--help`` runs; ``--quant`` reaches the model (int8 decode,
tests/test_torch_quant.py).
"""

import http.client
import io
import json
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
from conftest import make_config_dict
from PIL import Image

from pgica_tpu_torch.scripts import serve
from pgica_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
MAX_LENGTH = 8
CONFIG = make_config_dict(**{"model.projection_dim": 16, "data.max_caption_length": 8})  # tiny ViT + GPT-2


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(11).integers(0, 256, (5, 32, 32, 3), np.uint8)


@pytest.fixture(scope="module", params=["batch", "continuous"])
def service(request):
    config = Config(config_dict=CONFIG)
    if request.param == "batch":
        svc = serve.CaptionService(config, max_batch=4, max_length=MAX_LENGTH, device="cpu")
    else:
        svc = serve.ContinuousCaptionService(config, slots=2, chunk=2, max_length=MAX_LENGTH, device="cpu")
    svc.warmup()
    yield svc
    svc.shutdown()


def _submit_all(svc, images):
    out = [None] * len(images)

    def go(i):
        out[i] = svc.submit(images[i], timeout=120)["caption"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    return out


def test_service_captions_equal_generate_captions(service, images):
    want = service.model.generate_captions(images, max_length=MAX_LENGTH, early_stop=True)
    assert _submit_all(service, images) == want
    stats = service.stats()
    assert stats["status"] == "ok" and stats["served"] >= len(images) and "p95_ms" in stats


def _request(port, path, body=None, ctype="application/json"):
    """(status, JSON body) of a GET (no body) or POST to 127.0.0.1 (http.client takes no proxy)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        if body is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=body, headers={"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_handler_answers_healthz_caption_and_rejects_a_bad_body(service, images):
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        code, health = _request(port, "/healthz")
        assert code == 200 and health["status"] == "ok"
        want = service.model.generate_captions(images[:1], max_length=MAX_LENGTH, early_stop=True)[0]
        code, out = _request(port, "/caption", json.dumps({"image": images[0].tolist()}).encode())
        assert code == 200 and out["caption"] == want and out["latency_ms"] > 0
        jpeg = io.BytesIO()
        Image.fromarray(images[1]).save(jpeg, format="JPEG", quality=95)
        code, out = _request(port, "/caption", jpeg.getvalue(), ctype="image/jpeg")
        assert code == 200 and isinstance(out["caption"], str)
        code, out = _request(port, "/caption", b"{not json")
        assert code == 400 and "error" in out
        code, out = _request(port, "/nowhere")
        assert code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_cli_help_runs():
    result = subprocess.run([sys.executable, "-m", "pgica_tpu_torch.scripts.serve", "--help"],
                            capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert result.returncode == 0, result.stderr
    assert "--scheduler" in result.stdout and "--device" in result.stdout


def test_quant_raises_as_not_ported(tmp_path, monkeypatch):
    """``--quant`` was refused before int8 decode was ported; now it sets ``inference.quantization`` and the
    service decodes through the int8 twin (``--prejit`` warms every bucket and exits)."""
    import yaml

    from pgica_tpu_torch.utils import factories

    built = []
    create = factories.create_model
    monkeypatch.setattr(factories, "create_model", lambda *a, **kw: built.append(create(*a, **kw)) or built[-1])
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(CONFIG))
    for mode in ("int8", "int8_weight_only"):
        assert serve.main(["--config", str(path), "--quant", mode, "--device", "cpu", "--prejit", "--max-batch", "2",
                           "--max-length", "4"]) == 0
        assert built[-1].quantization == mode and built[-1]._quant_cache is not None
