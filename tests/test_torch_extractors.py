"""The port's feature extractors and perceptual loss against the JAX
package, on the CPU.

Every weight is drawn with numpy from a seed in the JAX package's layout
(the seeded extractor's HWIO ``filters`` and ``head``, InceptionV3's
nested tree, VGG16's ``[(w, b)]`` list) and crossed into the port through
``models/convert.py``; no JAX initializer runs. Tolerances are relative to
the largest magnitude of the JAX output: 1e-4 for the extractors, 1e-5 for
the VGG taps, the perceptual loss and its gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusion_model_universal_tpu.utils import benchmarks as jbench
from diffusion_model_universal_tpu.utils import inception as jinc
from diffusion_model_universal_tpu.utils import losses as jlosses
from diffusion_model_universal_tpu.utils import vgg as jvgg
from diffusion_model_universal_torch.models import convert
from diffusion_model_universal_torch.utils import benchmarks as tbench
from diffusion_model_universal_torch.utils import inception as tinc
from diffusion_model_universal_torch.utils import losses as tlosses
from diffusion_model_universal_torch.utils import vgg as tvgg

torch.set_num_threads(4)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def extractor_weights(seed=0, feature_dim=2048, num_classes=1000):
    """The seeded extractor's weights in the JAX layout, from numpy."""
    rng = np.random.default_rng(seed)
    filters, cin = [], 3
    for w in (64, 128, 256, 512, feature_dim):
        filters.append((rng.standard_normal((3, 3, cin, w), np.float32)
                        * np.float32((2.0 / (9 * cin)) ** 0.5)))
        cin = w
    head = (rng.standard_normal((feature_dim, num_classes), np.float32)
            * np.float32(feature_dim ** -0.5))
    return filters, head


def crossed_extractors(seed=0, feature_dim=2048, num_classes=1000):
    """(JAX FeatureExtractor, port FeatureExtractor) on the same numpy
    weights; the JAX object is built without its initializer."""
    filters, head = extractor_weights(seed, feature_dim, num_classes)
    jext = jbench.FeatureExtractor.__new__(jbench.FeatureExtractor)
    jext.filters = [jnp.asarray(f) for f in filters]
    jext.head = jnp.asarray(head)
    jext._extract = jax.jit(jext._extract_impl)
    text = tbench.FeatureExtractor(feature_dim=feature_dim,
                                   num_classes=num_classes, device="cpu")
    text.load_state_dict(convert.feature_extractor_state_dict_from_jax(
        filters, head), strict=True)
    return jext, text


def inception_tree(seed=0):
    """An InceptionV3 tree in the JAX layout with random BatchNorm
    statistics, from numpy."""
    rng = np.random.default_rng(seed)

    def conv(cout, kh, kw, cin):
        f = np.float32
        return {"w": (rng.standard_normal((kh, kw, cin, cout), f)
                      * f((2.0 / (kh * kw * cin)) ** 0.5)),
                "bn_w": rng.uniform(0.5, 1.5, cout).astype(f),
                "bn_b": (0.1 * rng.standard_normal(cout)).astype(f),
                "bn_mean": (0.1 * rng.standard_normal(cout)).astype(f),
                "bn_var": rng.uniform(0.5, 1.5, cout).astype(f)}

    tree, cin = {}, 3
    for name, cout, (kh, kw), _, _ in (s for s in jinc._STEM
                                       if not s[0].startswith("pool")):
        tree[name] = conv(cout, kh, kw, cin)
        cin = cout
    for name, kind, spec in jinc._LAYOUT:
        tree[name] = {b: conv(c, kh, kw, bc) for b, c, (kh, kw), bc
                      in jinc._branch_specs(kind, spec)}
    tree["fc"] = {"w": (rng.standard_normal((2048, 1000), np.float32)
                        * np.float32(2048 ** -0.5)),
                  "b": (0.1 * rng.standard_normal(1000)).astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def inc():
    """(tree, port InceptionV3 on it, jitted JAX forward, 75² input and
    the JAX outputs on it)."""
    tree = inception_tree()
    net = tinc.InceptionV3()
    net.load_state_dict(convert.inception_state_dict_from_jax(tree),
                        strict=True)
    fwd = jax.jit(jinc.inception_forward)
    x = np.random.default_rng(1).standard_normal((1, 75, 75, 3),
                                                 np.float32)
    feats, logits = fwd(tree, x)
    return tree, net.eval(), fwd, x, (np.asarray(feats), np.asarray(logits))


def _port_forward(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2))


# -- the seeded extractor ---------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 28, 28, 1),
                                   (2, 128, 128, 3)])
def test_seeded_extractor_matches_jax(shape):
    """32² and 28²×1 grow to 64²; 128² shrinks, which needs the
    antialiased resize; each stride-2 conv pads 0 before and 1 after."""
    jext, text = crossed_extractors(feature_dim=64, num_classes=10)
    x = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    jf, jl = jext(x)
    tf, tl = text(x)
    assert tf.shape == (2, 64) and tl.shape == (2, 10)
    _close(tf, jf, 1e-4)
    _close(tl, jl, 1e-4)


@pytest.mark.parametrize("size", [2, 4, 7, 32, 64, 75, 299])
def test_same_pads_are_xla_same(size):
    for k, s in ((3, 2), (3, 1), (1, 2)):
        assert [tbench.same_pads(size, k, s)] == list(
            jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME"))


@pytest.mark.parametrize("src,dst", [(32, 299), (28, 299), (128, 64),
                                     (512, 299)])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(3).standard_normal((1, src, src, 3),
                                                 np.float32)
    want = jax.image.resize(x, (1, dst, dst, 3), "bilinear")
    got = tinc.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    _close(got.permute(0, 2, 3, 1), want, 1e-5)


def test_seeded_extractor_is_seeded_and_warns_on_fallback(capsys):
    a, b = (tbench.FeatureExtractor(seed=3, feature_dim=16, num_classes=10,
                                    device="cpu") for _ in range(2))
    for (_, p), (_, q) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(p, q)
    ext = tbench.make_extractor(True, seed=3,
                                weights_path="/nonexistent.npz",
                                device="cpu")
    assert isinstance(ext, tbench.FeatureExtractor)
    assert torch.equal(ext.convs[0].weight, a.convs[0].weight)
    assert "Falling back" in capsys.readouterr().out


# -- InceptionV3 ----------------------------------------------------------

def test_inception_forward_matches_jax(inc):
    _, net, _, x, (jf, jl) = inc
    tf, tl = _port_forward(net, x)
    assert tf.shape == (1, 2048) and tl.shape == (1, 1000)
    _close(tf, jf, 1e-4)
    _close(tl, jl, 1e-4)


def test_torchvision_names_round_trip_through_jax(inc):
    """The port's state dict, read by the JAX package's torchvision
    converter, gives the JAX forward the same outputs: the port's names
    are torchvision's."""
    tree, net, fwd, x, (jf, jl) = inc
    sd = net.state_dict()
    for key in ("Conv2d_1a_3x3.conv.weight", "Conv2d_4a_3x3.bn.running_var",
                "Mixed_5b.branch5x5_2.conv.weight",
                "Mixed_6e.branch7x7dbl_5.bn.bias",
                "Mixed_7c.branch3x3dbl_3b.conv.weight", "fc.bias"):
        assert key in sd
    assert len(sd) == 94 * 6 + 2   # 94 BasicConv2d (conv + 5 bn), fc
    got_f, got_l = fwd(jinc.convert_torch_state_dict(sd), x)
    _close(got_f, jf, 1e-6)
    _close(got_l, jl, 1e-6)


def test_inception_weight_files_cross_both_ways(inc, tmp_path):
    """A JAX ``save_inception_npz`` file loads into the port; the port's
    ``.npz`` loads into JAX; a torchvision-style ``.pth`` with its
    AuxLogits entries loads strictly."""
    tree, net, _, x, (jf, _) = inc
    npz = str(tmp_path / "jax.npz")
    jinc.save_inception_npz(tree, npz)
    loaded = tinc.load_inception_params(npz)
    for k, v in net.state_dict().items():
        assert torch.equal(loaded[k], v), k

    ours = str(tmp_path / "port.npz")
    tinc.save_inception_npz(net, ours)
    back = jinc.load_inception_params(ours)
    for name in ("Conv2d_2b_3x3", "Mixed_6b"):
        a, b = jax.tree_util.tree_leaves(back[name]), \
            jax.tree_util.tree_leaves(tree[name])
        assert all(np.array_equal(np.asarray(p), q) for p, q in zip(a, b))

    pth = str(tmp_path / "tv.pth")
    torch.save({**net.state_dict(),
                "AuxLogits.fc.weight": torch.zeros(1000, 768)}, pth)
    loaded = tinc.load_inception_params(pth)
    assert loaded.keys() == net.state_dict().keys()
    tinc.InceptionV3().load_state_dict(loaded, strict=True)


def test_inception_extractor_preprocessing_matches_jax(inc):
    """[−1, 1] → [0, 1] → bilinear 299² → ImageNet mean/std, as the JAX
    InceptionExtractor's front end (the network itself is held above)."""
    x = np.random.default_rng(4).uniform(-1, 1, (1, 32, 32, 1)).astype(
        np.float32)
    x3 = jnp.repeat(x, 3, axis=-1)
    want = (jax.image.resize((x3 + 1.0) / 2.0, (1, 299, 299, 3),
                             "bilinear") - jinc._IMAGENET_MEAN) \
        / jinc._IMAGENET_STD
    h = (tinc.nhwc_to_nchw3(x, torch.device("cpu")) + 1.0) / 2.0
    got = tinc.imagenet_normalize(tinc.resize_bilinear(h, 299))
    _close(got.permute(0, 2, 3, 1), want, 1e-5)


# -- VGG16 and the perceptual loss ------------------------------------------

@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    rng = np.random.default_rng(5)
    params = [((rng.standard_normal((3, 3, cin, cout), np.float32)
                * np.float32((2.0 / (9 * cin)) ** 0.5)),
               (0.05 * rng.standard_normal(cout)).astype(np.float32))
              for _, cin, cout in jvgg._CONVS]
    path = str(tmp_path_factory.mktemp("vgg") / "vgg16.npz")
    jvgg.save_vgg16_npz(params, path)
    return params, path


def _images(seed, shape=(2, 16, 16, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def test_vgg_taps_match_jax(vgg_npz):
    params, path = vgg_npz
    net = tvgg.VGG16Features()
    net.load_state_dict(tvgg.load_vgg16_params(path), strict=True)
    x = _images(6)
    want = jvgg.vgg16_features([(jnp.asarray(w), jnp.asarray(b))
                                for w, b in params], x)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w, 1e-5)

    pth = str(vgg_npz[1]).replace(".npz", ".pth")
    sd = net.state_dict()
    torch.save({**sd, "features.16.weight": torch.zeros(3),
                "classifier.0.bias": torch.zeros(3)}, pth)
    for k, v in tvgg.load_vgg16_params(pth).items():
        assert torch.equal(v, sd[k])


def test_perceptual_loss_and_gradient_match_jax(vgg_npz):
    _, path = vgg_npz
    jloss = jlosses.PerceptualLoss(weights_path=path)
    tloss = tlosses.PerceptualLoss(weights_path=path)
    assert jloss.pretrained and tloss.pretrained
    pred, target = _images(7), _images(8)
    want, want_grad = jax.jit(jax.value_and_grad(jloss))(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_()
    got = tloss(p, torch.from_numpy(target))
    got.backward()
    _close(got.detach(), want, 1e-5)
    _close(p.grad, want_grad, 1e-5)
    # Each sample's distance is its batch of one's (held to JAX above).
    per = tloss.per_sample(torch.from_numpy(pred), torch.from_numpy(target))
    for i in range(2):
        _close(per[i], tloss(torch.from_numpy(pred[i:i + 1]),
                             torch.from_numpy(target[i:i + 1])), 1e-6)


def test_diffusion_loss_perceptual_term_matches_jax(vgg_npz, monkeypatch):
    """``loss_config.perceptual_weight`` adds weight × the VGG distance in
    both packages (weights from ``DMU_VGG16_WEIGHTS``), to the batch loss
    and to each sample's loss."""
    monkeypatch.setenv("DMU_VGG16_WEIGHTS", vgg_npz[1])
    cfg = {"perceptual_weight": 0.1, "time_weight_type": "linear"}
    jl = jlosses.DiffusionLoss("mse", cfg, num_timesteps=10)
    tl = tlosses.DiffusionLoss("mse", cfg, num_timesteps=10)
    pred, target = _images(9), _images(10)
    t = np.array([1, 7])
    want = jax.jit(jl.__call__)(jnp.asarray(pred), jnp.asarray(target),
                                jnp.asarray(t))
    args = [torch.from_numpy(a) for a in (pred, target, t)]
    _close(tl(*args), want, 1e-5)
    # Each sample's loss is its batch of one's, as the reference's
    # vmapped eval has it (over one sample the time weight is min_weight).
    per = tl.per_sample(*args)
    for i in range(2):
        _close(per[i], tl(*(a[i:i + 1] for a in args)), 1e-6)


def test_perceptual_loss_without_weights_is_seeded():
    a = tlosses.PerceptualLoss(seed=1)
    b = tlosses.PerceptualLoss(seed=1)
    assert not a.pretrained
    x, y = torch.from_numpy(_images(11)), torch.from_numpy(_images(12))
    assert float(a(x, y)) == float(b(x, y)) > 0.0
