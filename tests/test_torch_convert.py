"""The weight bridge, the configuration copy, the device policy and the
no-JAX import guard of the PyTorch/CUDA port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.core import config as jconfig  # noqa: E402
from icka_tpu.nn.layers import Dense as JaxDense  # noqa: E402
from icka_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from icka_tpu_torch.core import config as tconfig  # noqa: E402
from icka_tpu_torch.core.device import resolve_device  # noqa: E402
from icka_tpu_torch.models.icka import ICKAModel  # noqa: E402
from icka_tpu_torch.nn.layers import Dense  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_jax_in_the_port():
    """Importing the evaluation and training entry points, the optimizer,
    the data plane and the weight loaders, the package's lazy attributes,
    then every module of icka_tpu_torch, pulls in no jax, flax, optax or
    icka_tpu, and none of regex, msgpack, PIL, safetensors, transformers or
    tensorflow, which the card's machine lacks. A fresh interpreter: this
    process has jax loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('cli.evaluate', 'data.loader', 'data.features', "
        "'data.tokenization', 'core.checkpoint', 'train.trainer', "
        "'train.optimizer', 'cli.train', 'models.pretrained', "
        "'models.tf_convert', 'cli.convert'):\n"
        "    importlib.import_module('icka_tpu_torch.' + m)\n"
        "import icka_tpu_torch\n"
        "for name in icka_tpu_torch._LAZY: getattr(icka_tpu_torch, name)\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "icka_tpu_torch.__path__, 'icka_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'icka_tpu', 'regex', 'msgpack', "
        "'PIL', 'safetensors', 'transformers', 'tensorflow'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 30 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dense_kernel_is_transposed():
    x = np.random.default_rng(0).standard_normal((2, 6)).astype(np.float32)
    v = jax.device_get(JaxDense(5).init(jax.random.PRNGKey(0), x))
    sd = state_dict_from_flax(v["params"])
    assert tuple(sd["weight"].shape) == (5, 6)
    np.testing.assert_array_equal(sd["weight"].numpy(),
                                  v["params"]["kernel"].T)


def test_strict_loading_rejects_missing_and_extra_names():
    m = Dense(6, 5, device="cpu")
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    m.load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError):
        m.load_state_dict({"weight": sd["weight"]}, strict=True)
    with pytest.raises(RuntimeError):
        m.load_state_dict(dict(sd, extra=sd["bias"]), strict=True)


def test_config_json_written_by_jax_loads_unchanged(tmp_path):
    """Field names and defaults are the JAX package's, so its config.json
    loads here and writes back byte for byte."""
    for jcls, tcls in ((jconfig.ICKAConfig, tconfig.ICKAConfig),
                       (jconfig.EncoderConfig, tconfig.EncoderConfig)):
        for cfg in (jcls(), jcls.tiny()):
            path = tmp_path / "config.json"
            jconfig.save_config(cfg, str(path))
            loaded = tconfig.load_config(tcls, str(path))
            assert tconfig.to_json(loaded) == jconfig.to_json(cfg)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        ICKAModel(tconfig.ICKAConfig.tiny())
    assert resolve_device("cpu") == torch.device("cpu")
