"""Plain PyTorch MN and DyMN over a state dict with upstream's key names.

Each model is the published EfficientAT network (models/mn/model.py and
models/dymn/model.py of github.com/fschmid56/EfficientAT), written as
functions of the configuration file's block table and of a flat state dict,
in float32 with no kernel of the program. ``param_specs`` lists the state
dict's keys, shapes and the scale of their seeded draw; ``forward`` maps
(B, 1, n_mels, frames) log-mels to logits. ``training=True`` runs BatchNorm
on the batch's statistics (updating the running buffers in place) and the
head's dropout from the current torch generator of the input's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ACT = {"RE": F.relu, "HS": F.hardswish}
# draw gains of DyMN's per-clip parts (the banks' attention, DyReLU's
# coefficients, coordinate attention): small, so that a clip's kernels and
# gates stay near their mean and the network stays stable in inference mode
DYNAMIC_GAIN = 0.0025


def _blocks(cfg):
    cols = cfg["block_columns"]
    return [dict(zip(cols, row)) for row in cfg["blocks"]]


def _prefixes(cfg):
    """Key prefixes of the stem, the blocks, the tail and the head."""
    if cfg["family"] == "mn":
        n = len(cfg["blocks"])
        return "features.0", [f"features.{i + 1}" for i in range(n)], f"features.{n + 1}"
    return "in_c", [f"layers.{i}" for i in range(len(cfg["blocks"]))], "out_c"


def param_specs(cfg) -> list:
    """[(key, shape, std, mean)] of every state-dict entry; a BatchNorm's
    ``num_batches_tracked`` has std None (an int64 zero). A weight's draw is
    N(0, gain / fan_in): gain 2 before a rectifier, 1 otherwise,
    ``DYNAMIC_GAIN`` for DyMN's per-clip parts."""
    specs = []

    def conv(key, o, i, k, gain=2.0, bias=False):
        specs.append((f"{key}.weight", (o, i, k, k), math.sqrt(gain / (i * k * k)), 0.0))
        if bias:
            specs.append((f"{key}.bias", (o,), 0.1, 0.0))

    def linear(key, o, i, gain=1.0):
        specs.append((f"{key}.weight", (o, i), math.sqrt(gain / i), 0.0))
        specs.append((f"{key}.bias", (o,), 0.1, 0.0))

    def bn(key, c):
        specs.extend([(f"{key}.weight", (c,), 0.1, 1.0), (f"{key}.bias", (c,), 0.1, 0.0),
                      (f"{key}.running_mean", (c,), 0.1, 0.0),
                      (f"{key}.running_var", (c,), 0.1, 1.0),
                      (f"{key}.num_batches_tracked", (), None, 0.0)])

    stem, blocks, tail = _prefixes(cfg)
    s = cfg["stem"]
    conv(f"{stem}.0", s["channels"], 1, s["kernel"])
    bn(f"{stem}.1", s["channels"])
    for p, b in zip(blocks, _blocks(cfg)):
        cin, k, exp, cout = b["in"], b["kernel"], b["expanded"], b["out"]
        if cfg["family"] == "mn":
            j = 0
            if exp != cin:
                conv(f"{p}.block.0.0", exp, cin, 1)
                bn(f"{p}.block.0.1", exp)
                j = 1
            conv(f"{p}.block.{j}.0", exp, 1, k)
            bn(f"{p}.block.{j}.1", exp)
            if b["se_squeeze"]:
                j += 1
                linear(f"{p}.block.{j}.conc_se_layers.0.fc1", b["se_squeeze"], exp, 2.0)
                linear(f"{p}.block.{j}.conc_se_layers.0.fc2", exp, b["se_squeeze"])
            conv(f"{p}.block.{j + 1}.0", cout, exp, 1, gain=1.0)
            bn(f"{p}.block.{j + 1}.1", cout)
            continue
        h, kk = b["context"], cfg["dynamic"]["dyconv_k"]
        m = cfg["dynamic"]["dyrelu_m"]
        conv(f"{p}.context_gen.joint_conv", h, cin, 1)
        bn(f"{p}.context_gen.joint_norm", h)
        conv(f"{p}.context_gen.conv_f", exp, h, 1, gain=DYNAMIC_GAIN, bias=True)
        conv(f"{p}.context_gen.conv_t", exp, h, 1, gain=DYNAMIC_GAIN, bias=True)

        def dyconv(key, o, per_out, gain=2.0):
            # the K banks mix with softmax weights, about 1 / K each: each
            # bank at K times the variance keeps the mixed kernel's
            specs.append((f"{key}.weight", (1, 1, kk, o * per_out),
                          math.sqrt(kk * gain / per_out), 0.0))
            linear(f"{key}.residuals.0", kk, h, DYNAMIC_GAIN)

        if exp != cin:
            dyconv(f"{p}.exp_conv", exp, cin)
            bn(f"{p}.exp_norm", exp)
        dyconv(f"{p}.depth_conv", exp, k * k)
        bn(f"{p}.depth_norm", exp)
        linear(f"{p}.depth_act.coef_net.0", 2 * m * exp, h, DYNAMIC_GAIN)
        dyconv(f"{p}.proj_conv", cout, exp, gain=1.0)
        bn(f"{p}.proj_norm", cout)
    c_last = cfg["blocks"][-1][3]
    conv(f"{tail}.0", cfg["tail_channels"], c_last, 1)
    bn(f"{tail}.1", cfg["tail_channels"])
    linear("classifier.2", cfg["last_channel"], cfg["tail_channels"], 2.0)
    linear("classifier.5", cfg["num_classes"], cfg["last_channel"])
    return specs


def residual_last_norms(cfg) -> list:
    """The last BatchNorm of each block that adds its input back."""
    stem, prefixes, tail = _prefixes(cfg)
    out = []
    for p, b in zip(prefixes, _blocks(cfg)):
        if b["stride"] != 1 or b["in"] != b["out"]:
            continue
        if cfg["family"] == "dymn":
            out.append(f"{p}.proj_norm")
        else:
            last = 1 + (b["expanded"] != b["in"]) + bool(b["se_squeeze"])
            out.append(f"{p}.block.{last}.1")
    return out


class _Net:
    """The state dict read as a network; ``training`` picks BatchNorm's
    statistics and turns the dropout on."""

    def __init__(self, cfg, sd, training, bn_momentum=None):
        self.cfg, self.sd, self.training = cfg, sd, training
        self.momentum = cfg["bn_momentum"] if bn_momentum is None else bn_momentum

    def bn(self, key, x):
        sd = self.sd
        return F.batch_norm(x, sd[f"{key}.running_mean"], sd[f"{key}.running_var"],
                            sd[f"{key}.weight"], sd[f"{key}.bias"], self.training,
                            self.momentum, self.cfg["bn_eps"])

    def conv_bn(self, key, x, stride=1, groups=1, act=None):
        w = self.sd[f"{key}.0.weight"]
        x = F.conv2d(x, w, None, stride, (w.shape[-1] - 1) // 2, 1, groups)
        x = self.bn(f"{key}.1", x)
        return act(x) if act is not None else x

    def linear(self, key, x):
        return F.linear(x, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"])

    def head(self, key_tail, x):
        x = self.conv_bn(key_tail, x, act=F.hardswish)
        x = x.mean(dim=(2, 3))
        x = F.hardswish(self.linear("classifier.2", x))
        x = F.dropout(x, self.cfg["dropout"], self.training)
        return self.linear("classifier.5", x)

    def mn_block(self, p, b, x):
        act = ACT[b["act"]]
        j, out = 0, x
        if b["expanded"] != b["in"]:
            out = self.conv_bn(f"{p}.block.0", out, act=act)
            j = 1
        out = self.conv_bn(f"{p}.block.{j}", out, b["stride"], b["expanded"], act)
        if b["se_squeeze"]:
            j += 1
            se = f"{p}.block.{j}.conc_se_layers.0"
            s = F.relu(self.linear(f"{se}.fc1", out.mean(dim=(2, 3))))
            out = out * torch.sigmoid(self.linear(f"{se}.fc2", s))[:, :, None, None]
        out = self.conv_bn(f"{p}.block.{j + 1}", out)
        return out + x if b["stride"] == 1 and b["in"] == b["out"] else out

    def dyconv(self, key, x, h_c, temperature, kernel=1, stride=1):
        """K banks mixed per clip by softmax(Linear(h_c) / T); a 1x1 as a
        batched product, a depthwise kxk as a grouped conv over the folded
        batch (upstream's form)."""
        kk = self.cfg["dynamic"]["dyconv_k"]
        att = torch.softmax(self.linear(f"{key}.residuals.0", h_c) / temperature, dim=-1)
        wb = att @ self.sd[f"{key}.weight"].reshape(kk, -1)
        b, c, f, t = x.shape
        if kernel == 1:
            y = torch.bmm(wb.reshape(b, -1, c), x.reshape(b, c, f * t))
            return y.reshape(b, -1, f, t)
        y = F.conv2d(x.reshape(1, b * c, f, t), wb.reshape(b * c, 1, kernel, kernel),
                     None, stride, (kernel - 1) // 2, 1, b * c)
        return y.reshape(b, c, y.shape[2], y.shape[3])

    def dy_block(self, p, b, x, temperature):
        inp, stride = x, b["stride"]
        f, t = x.shape[2], x.shape[3]
        cg = f"{p}.context_gen"
        pooled = torch.cat([x.mean(dim=3, keepdim=True),
                            x.mean(dim=2, keepdim=True).transpose(2, 3)], dim=2)
        g = F.conv2d(pooled, self.sd[f"{cg}.joint_conv.weight"])
        g = F.hardswish(self.bn(f"{cg}.joint_norm", g))
        h_c = g.mean(dim=(2, 3))
        h_cf, h_ct = torch.split(g, [f, t], dim=2)
        h_ct = h_ct.transpose(2, 3)
        if stride > 1:
            h_cf = F.avg_pool2d(h_cf, (3, 1), (stride, 1), (1, 0))
            h_ct = F.avg_pool2d(h_ct, (1, 3), (1, stride), (0, 1))
        g_cf = F.conv2d(h_cf, self.sd[f"{cg}.conv_f.weight"], self.sd[f"{cg}.conv_f.bias"])
        g_ct = F.conv2d(h_ct, self.sd[f"{cg}.conv_t.weight"], self.sd[f"{cg}.conv_t.bias"])
        if b["expanded"] != b["in"]:
            x = self.dyconv(f"{p}.exp_conv", x, h_c, temperature)
            x = ACT[b["act"]](self.bn(f"{p}.exp_norm", x))
        x = self.dyconv(f"{p}.depth_conv", x, h_c, temperature, b["kernel"], stride)
        x = self.bn(f"{p}.depth_norm", x)
        # DyReLU-B: slopes theta_0 + 1, theta_1; intercepts theta_2 / 2, theta_3 / 2
        m = self.cfg["dynamic"]["dyrelu_m"]
        theta = 2.0 * torch.sigmoid(self.linear(f"{p}.depth_act.coef_net.0", h_c)) - 1.0
        theta = theta.reshape(x.shape[0], x.shape[1], 1, 1, 2 * m)
        slopes = [theta[..., 0] + 1.0] + [theta[..., i] for i in range(1, m)]
        x = torch.stack([x * slopes[i] + 0.5 * theta[..., m + i] for i in range(m)]).amax(0)
        x = x * torch.sigmoid(g_cf) * torch.sigmoid(g_ct)
        x = self.bn(f"{p}.proj_norm", self.dyconv(f"{p}.proj_conv", x, h_c, temperature))
        return x + inp if stride == 1 and b["in"] == b["out"] else x


def forward(cfg, sd, mel, *, training=False, temperature=None, bn_momentum=None):
    """Log-mels (B, 1, n_mels, frames) -> logits (B, classes). A DyMN runs
    at ``temperature`` (default: the configuration's ``t_max``). In
    training, ``bn_momentum`` replaces the configuration's (1.0 sets each
    running statistic to the batch's)."""
    net = _Net(cfg, sd, training, bn_momentum)
    stem, prefixes, tail = _prefixes(cfg)
    x = net.conv_bn(stem, mel, cfg["stem"]["stride"], act=F.hardswish)
    if cfg["family"] == "mn":
        for p, b in zip(prefixes, _blocks(cfg)):
            x = net.mn_block(p, b, x)
    else:
        t = cfg["dynamic"]["t_max"] if temperature is None else temperature
        for p, b in zip(prefixes, _blocks(cfg)):
            x = net.dy_block(p, b, x, t)
    return net.head(tail, x)
