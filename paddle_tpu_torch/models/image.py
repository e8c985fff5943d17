"""Image-classification model zoo.

Reference configs: benchmark/paddle/image/{alexnet,googlenet,
smallnet_mnist_cifar}.py, v1_api_demo/mnist/light_mnist.py,
v1_api_demo/model_zoo/resnet/resnet.py,
trainer_config_helpers/networks.py:465 vgg_16_network. Rebuilt with the
paddle_tpu DSL in NHWC; all convs run on the MXU via XLA.
"""

from __future__ import annotations

from paddle_tpu_torch import dsl
from paddle_tpu_torch.core.config import ModelConf


def _head(g, feat, num_classes, label):
    out = dsl.fc(feat, size=num_classes, name="output")
    cost = dsl.classification_cost(out, label)
    g.conf.output_layer_names.append("output")
    return out


def lenet(image_shape=(28, 28, 1), num_classes=10) -> ModelConf:
    """LeNet-style mnist net (v1_api_demo/mnist/light_mnist.py)."""
    with dsl.model() as g:
        img = dsl.data("image", image_shape)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = dsl.conv(img, 32, 5, padding=2, act="relu")
        h = dsl.pool(h, 2, 2)
        h = dsl.conv(h, 64, 5, padding=2, act="relu")
        h = dsl.pool(h, 2, 2)
        h = dsl.fc(h, size=128, act="tanh")
        _head(g, h, num_classes, lbl)
    return g.conf


def smallnet_mnist_cifar(image_shape=(32, 32, 3), num_classes=10) -> ModelConf:
    """cifar10-quick (benchmark/paddle/image/smallnet_mnist_cifar.py)."""
    with dsl.model() as g:
        img = dsl.data("image", image_shape)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = dsl.conv(img, 32, 5, padding=2, act="relu")
        h = dsl.pool(h, 3, 2, padding=1)
        h = dsl.conv(h, 32, 5, padding=2, act="relu")
        h = dsl.pool(h, 3, 2, padding=1, pool_type="avg")
        h = dsl.conv(h, 64, 5, padding=2, act="relu")
        h = dsl.pool(h, 3, 2, padding=1, pool_type="avg")
        h = dsl.fc(h, size=64, act="relu")
        _head(g, h, num_classes, lbl)
    return g.conf


def alexnet(image_shape=(224, 224, 3), num_classes=1000) -> ModelConf:
    """(benchmark/paddle/image/alexnet.py)."""
    with dsl.model() as g:
        img = dsl.data("image", image_shape)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = dsl.conv(img, 64, 11, stride=4, padding=2, act="relu")
        h = dsl.lrn(h, size=5)
        h = dsl.pool(h, 3, 2)
        h = dsl.conv(h, 192, 5, padding=2, act="relu")
        h = dsl.lrn(h, size=5)
        h = dsl.pool(h, 3, 2)
        h = dsl.conv(h, 384, 3, padding=1, act="relu")
        h = dsl.conv(h, 256, 3, padding=1, act="relu")
        h = dsl.conv(h, 256, 3, padding=1, act="relu")
        h = dsl.pool(h, 3, 2)
        h = dsl.fc(h, size=4096, act="relu", drop_rate=0.5)
        h = dsl.fc(h, size=4096, act="relu", drop_rate=0.5)
        _head(g, h, num_classes, lbl)
    return g.conf


def vgg16(image_shape=(224, 224, 3), num_classes=1000,
          with_batchnorm=False) -> ModelConf:
    """(trainer_config_helpers/networks.py:465 vgg_16_network)."""
    with dsl.model() as g:
        img = dsl.data("image", image_shape)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = img
        for nfs in ([64, 64], [128, 128], [256, 256, 256],
                    [512, 512, 512], [512, 512, 512]):
            h = dsl.img_conv_group(
                h, nfs, 3, 2, 2, conv_with_batchnorm=with_batchnorm
            )
        h = dsl.fc(h, size=4096, act="relu", drop_rate=0.5)
        h = dsl.fc(h, size=4096, act="relu", drop_rate=0.5)
        _head(g, h, num_classes, lbl)
    return g.conf


def _inception(name, x, nf1, nf3r, nf3, nf5r, nf5, proj):
    """GoogleNet inception-v1 block (benchmark/paddle/image/googlenet.py)."""
    b1 = dsl.conv(x, nf1, 1, act="relu", name=f"{name}_1x1")
    b3 = dsl.conv(x, nf3r, 1, act="relu", name=f"{name}_3x3r")
    b3 = dsl.conv(b3, nf3, 3, padding=1, act="relu", name=f"{name}_3x3")
    b5 = dsl.conv(x, nf5r, 1, act="relu", name=f"{name}_5x5r")
    b5 = dsl.conv(b5, nf5, 5, padding=2, act="relu", name=f"{name}_5x5")
    bp = dsl.pool(x, 3, 1, padding=1, name=f"{name}_pool")
    bp = dsl.conv(bp, proj, 1, act="relu", name=f"{name}_proj")
    return dsl.concat(b1, b3, b5, bp, name=f"{name}_out")


def googlenet(image_shape=(224, 224, 3), num_classes=1000) -> ModelConf:
    with dsl.model() as g:
        img = dsl.data("image", image_shape)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = dsl.conv(img, 64, 7, stride=2, padding=3, act="relu")
        h = dsl.pool(h, 3, 2, padding=1)
        h = dsl.conv(h, 64, 1, act="relu")
        h = dsl.conv(h, 192, 3, padding=1, act="relu")
        h = dsl.pool(h, 3, 2, padding=1)
        h = _inception("i3a", h, 64, 96, 128, 16, 32, 32)
        h = _inception("i3b", h, 128, 128, 192, 32, 96, 64)
        h = dsl.pool(h, 3, 2, padding=1)
        h = _inception("i4a", h, 192, 96, 208, 16, 48, 64)
        h = _inception("i4b", h, 160, 112, 224, 24, 64, 64)
        h = _inception("i4c", h, 128, 128, 256, 24, 64, 64)
        h = _inception("i4d", h, 112, 144, 288, 32, 64, 64)
        h = _inception("i4e", h, 256, 160, 320, 32, 128, 128)
        h = dsl.pool(h, 3, 2, padding=1)
        h = _inception("i5a", h, 256, 160, 320, 32, 128, 128)
        h = _inception("i5b", h, 384, 192, 384, 48, 128, 128)
        h = dsl.pool(h, max(image_shape[0] // 32, 1), 1, pool_type="avg")
        h = dsl.dropout(h, 0.4)
        _head(g, h, num_classes, lbl)
    return g.conf


def _bottleneck(name, x, ch, stride, project, fused=False):
    """ResNet bottleneck: 1x1 -> 3x3 -> 1x1(4ch) + shortcut
    (v1_api_demo/model_zoo/resnet/resnet.py bottleneck blocks).
    fused=True routes the stride-1 1x1 sites through the Mosaic
    fused BN/ReLU/GEMM layers (layers/fused.py, the MFU lever) —
    same math, fewer HBM passes."""
    if fused and stride == 1:
        h = dsl.fused_conv1x1_bn(x, ch, act="relu", name=f"{name}_a")
    else:
        h = dsl.conv(x, ch, 1, stride=stride, act="", bias=False,
                     name=f"{name}_a")
        h = dsl.batch_norm(h, act="relu", name=f"{name}_a_bn")
    h = dsl.conv(h, ch, 3, padding=1, act="", bias=False, name=f"{name}_b")
    if project:
        sc = dsl.conv(x, ch * 4, 1, stride=stride, act="", bias=False,
                      name=f"{name}_sc")
        sc = dsl.batch_norm(sc, act="", name=f"{name}_sc_bn")
    else:
        sc = x
    if fused:
        return dsl.fused_bottleneck_tail(
            h, ch * 4, residual=sc, act="relu", name=f"{name}_tail"
        )
    h = dsl.batch_norm(h, act="relu", name=f"{name}_b_bn")
    h = dsl.conv(h, ch * 4, 1, act="", bias=False, name=f"{name}_c")
    h = dsl.batch_norm(h, act="", name=f"{name}_c_bn")
    return dsl.addto(h, sc, act="relu", name=f"{name}_add")


def resnet(depth=50, image_shape=(224, 224, 3), num_classes=1000,
           fused=False) -> ModelConf:
    """ResNet-50/101/152 (v1_api_demo/model_zoo/resnet/resnet.py).
    fused=True uses the Mosaic fused bottleneck layers (new parameter
    names — not checkpoint-compatible with the plain graph)."""
    stages = {
        50: (3, 4, 6, 3),
        101: (3, 4, 23, 3),
        152: (3, 8, 36, 3),
    }[depth]
    with dsl.model() as g:
        img = dsl.data("image", image_shape)
        lbl = dsl.data("label", (1,), is_ids=True)
        h = dsl.conv(img, 64, 7, stride=2, padding=3, act="", bias=False,
                     name="conv1")
        h = dsl.batch_norm(h, act="relu", name="conv1_bn")
        h = dsl.pool(h, 3, 2, padding=1)
        for si, (n_blocks, ch) in enumerate(zip(stages, (64, 128, 256, 512))):
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                h = _bottleneck(
                    f"res{si + 2}{chr(ord('a') + bi)}", h, ch, stride,
                    project=(bi == 0), fused=fused,
                )
        final = max(image_shape[0] // 32, 1)  # global avg pool
        h = dsl.pool(h, final, 1, pool_type="avg")
        _head(g, h, num_classes, lbl)
    return g.conf
