"""The port's conversion CLI (`icka_tpu_torch.cli.convert`) and converters
against the JAX package's on the CPU: each of the five kinds through both
CLIs on the same source gives the same file, byte for byte, and each
package's output read by the other's `restore_pytree` is bit-equal;
`resnet_params_from_torch`, `cross_encoder_params_from_torch` and the
BiLSTM and CRF converters give the JAX package's leaves.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from icka_tpu.cli import convert as jcli  # noqa: E402
from icka_tpu.core.checkpoint import restore_pytree as jrestore  # noqa: E402
from icka_tpu.models import convert as jconvert  # noqa: E402
from icka_tpu.models import resnet as jresnet  # noqa: E402
from icka_tpu.models import tf_convert as jtf  # noqa: E402
from icka_tpu_torch.cli import convert as tcli  # noqa: E402
from icka_tpu_torch.core.checkpoint import restore_pytree  # noqa: E402
from icka_tpu_torch.models import convert as tconvert  # noqa: E402
from icka_tpu_torch.models import resnet as tresnet  # noqa: E402
from tests.test_torch_pretrained import (_hf_dir,  # noqa: E402
                                         assert_trees_equal)
from tests.test_torch_tf_convert import _encoder_params  # noqa: E402


def _lstm_crf_bundle(path, legacy=False):
    """A reference best-checkpoint bundle: {'net': state dict} holding a
    bidirectional `nn.LSTM` under "lstm." and torchcrf's CRF under "crf."
    (and weights of other modules, which the CLI leaves out)."""
    torch.manual_seed(1)
    lstm = torch.nn.LSTM(12, 6, bidirectional=True, batch_first=True)
    sd = {f"lstm.{k}": v for k, v in lstm.state_dict().items()}
    for name, shape in (("start_transitions", (5,)),
                        ("end_transitions", (5,)), ("transitions", (5, 5))):
        sd[f"crf.{name}"] = torch.randn(shape)
    sd["classifier.weight"] = torch.randn(5, 12)
    torch.save({"net": sd}, path)
    return sd


def _sources(tmp_path, rng):
    """{kind: source path} for every kind of both CLIs."""
    from tests.test_resnet import TorchResNet

    hf, _ = _hf_dir(tmp_path)
    torch.manual_seed(0)
    resnet = tmp_path / "resnet152.pth"
    torch.save(TorchResNet((1, 1, 1, 1)).state_dict(), resnet)
    bundle = tmp_path / "model.pth"
    _lstm_crf_bundle(bundle)
    prefix = str(tmp_path / "tf" / "model.ckpt")
    jtf.write_tf_checkpoint(prefix,
                            jtf.encoder_params_to_tf(_encoder_params(rng)))
    return {"roberta": str(hf), "bert": str(hf), "resnet": str(resnet),
            "icka": str(bundle), "tf_bert": prefix + ".index"}


def _outputs(kind, dst):
    if kind == "icka":
        return [dst / "lstm.msgpack", dst / "crf.msgpack"]
    return [dst]


@pytest.mark.parametrize("kind", ["roberta", "bert", "resnet", "icka",
                                  "tf_bert"])
def test_both_clis_write_the_same_file(tmp_path, rng, kind):
    src = _sources(tmp_path, rng)[kind]
    name = "out" if kind == "icka" else "out.msgpack"
    port_dst, jax_dst = tmp_path / "port" / name, tmp_path / "jax" / name
    for d in (port_dst, jax_dst):
        d.parent.mkdir(exist_ok=True)
    tcli.main([kind, "--src", src, "--dst", str(port_dst)])
    jcli.main([kind, "--src", src, "--dst", str(jax_dst)])
    for p, j in zip(_outputs(kind, port_dst), _outputs(kind, jax_dst)):
        assert p.read_bytes() == j.read_bytes(), p.name
        port_tree = restore_pytree(str(p))
        # each package's file read by the other's restore_pytree
        assert_trees_equal(restore_pytree(str(j)), port_tree)
        assert_trees_equal(jax.device_get(jrestore(str(p), port_tree)),
                           port_tree)


def test_resnet_params_from_torch_equals_jax():
    from tests.test_resnet import TorchResNet

    torch.manual_seed(0)
    sd = TorchResNet((1, 2, 1, 1)).state_dict()
    got = tresnet.resnet_params_from_torch(sd)
    assert_trees_equal(got, jresnet.resnet_params_from_torch(sd))
    assert_trees_equal(tresnet.resnet_params_from_torch(sd, (1, 2, 1, 1)),
                       got)
    assert sorted(got["params"]["resnet"]) == [
        "layer1_0", "layer2_0", "layer2_1", "layer3_0", "layer4_0", "stem"]


def test_lstm_crf_and_cross_encoder_converters_equal_jax(tmp_path, rng):
    sd = _lstm_crf_bundle(tmp_path / "m.pth")
    lstm = {k[len("lstm."):]: v for k, v in sd.items()
            if k.startswith("lstm.")}
    assert_trees_equal(tconvert.lstm_params_from_torch(lstm),
                       jconvert.lstm_params_from_torch(lstm))
    assert_trees_equal(tconvert.lstm_params_from_torch(sd, prefix="lstm."),
                       jconvert.lstm_params_from_torch(sd, prefix="lstm."))
    assert_trees_equal(tconvert.crf_params_from_torch(sd, prefix="crf."),
                       jconvert.crf_params_from_torch(sd, prefix="crf."))

    # a reference BertCrossEncoder, legacy LayerNorm gamma/beta names
    H, I = 8, 16
    cross = {}
    for i in range(2):
        p = f"txt2img.layer.{i}"
        for name, (o, n) in (("attention.self.query", (H, H)),
                             ("attention.self.key", (H, H)),
                             ("attention.self.value", (H, H)),
                             ("attention.output.dense", (H, H)),
                             ("intermediate.dense", (I, H)),
                             ("output.dense", (H, I))):
            cross[f"{p}.{name}.weight"] = torch.randn(o, n)
            cross[f"{p}.{name}.bias"] = torch.randn(o)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            cross[f"{p}.{ln}.gamma"] = torch.randn(H)
            cross[f"{p}.{ln}.beta"] = torch.randn(H)
    got = tconvert.cross_encoder_params_from_torch(cross, 2,
                                                   prefix="txt2img.")
    assert_trees_equal(got, jconvert.cross_encoder_params_from_torch(
        cross, 2, prefix="txt2img."))
    np.testing.assert_array_equal(
        got["layer_1"]["attn"]["key"]["kernel"],
        cross["txt2img.layer.1.attention.self.key.weight"].numpy().T)
