"""Checkpoint hub: name -> (MN, DyMN, PaSST or HTS-AT config, mel config,
release file) (port of efficientat_tpu/models/registry.py).

Every name of the JAX registry is here with its own ``MelConfig``, and
beside them two transformers that the JAX package has not: PaSST-S, whose
ensemble taught the zoo by distillation (github.com/kkoutini/PaSST; its
release file is on PaSST's own release page, ``PASST_RELEASE_URL``; its mel
front end is EfficientAT's default, which was taken from PaSST), and HTS-AT,
LAION-CLAP's audio tower (github.com/RetroCirce/HTS-Audio-Transformer), on
its own front end, torchlibrosa's (``LibrosaMelConfig``). HTS-AT's
checkpoints are in a folder that the repository's README links, not on a
release page: ``HTSAT_RELEASE_URL`` is the repository, and the file name is
the README's AudioSet checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn

from efficientat_tpu_torch.models.dymn import DyMN, DyMNConfig, init_weights
from efficientat_tpu_torch.models.htsat import HTSAT, HTSATConfig
from efficientat_tpu_torch.models.htsat import init_weights as init_htsat
from efficientat_tpu_torch.models.mn import MN, MNConfig
from efficientat_tpu_torch.models.passt import PaSST, PaSSTConfig
from efficientat_tpu_torch.models.passt import init_weights as init_passt
from efficientat_tpu_torch.ops.melspec import LibrosaMelConfig, MelConfig
from efficientat_tpu_torch.utils.common import NAME_TO_WIDTH

RELEASE_URL = "https://github.com/fschmid56/EfficientAT/releases/download/v0.0.1/"
PASST_RELEASE_URL = "https://github.com/kkoutini/PaSST/releases/download/v0.0.1-audioset/"
HTSAT_RELEASE_URL = "https://github.com/RetroCirce/HTS-Audio-Transformer#"
MODEL_DIR = "resources"


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    file: str  # filename on the release page
    model_cfg: Union[MNConfig, DyMNConfig, PaSSTConfig, HTSATConfig]
    mel_cfg: Union[MelConfig, LibrosaMelConfig] = MelConfig()
    release_url: str = RELEASE_URL

    @property
    def url(self) -> str:
        return self.release_url + self.file


def _mn(name, file, *, head="mlp", strides=(2, 2, 2, 2), mel=None):
    return ModelSpec(name, file,
                     MNConfig(width_mult=NAME_TO_WIDTH(name), head_type=head,
                              strides=tuple(strides)),
                     mel or MelConfig())


def _dymn(name, file, *, use_dy_blocks="all", t_max=1.0):
    """DyMN: AudioSet checkpoints finished training at temperature 1.0,
    ImageNet ones at 30.0 (models/dymn/model.py:336-340)."""
    return ModelSpec(name, file,
                     DyMNConfig(width_mult=NAME_TO_WIDTH(name),
                                use_dy_blocks=use_dy_blocks, t_max=t_max))


_SPECS = [
    # ImageNet-pretrained MN (1 input channel, AudioSet-ready head shapes)
    _mn("mn10_im_pytorch", "mn10_im_pytorch.pt"),
    _mn("mn01_im", "mn01_im.pt"),
    _mn("mn02_im", "mn02_im.pt"),
    _mn("mn04_im", "mn04_im.pt"),
    _mn("mn05_im", "mn05_im.pt"),
    _mn("mn10_im", "mn10_im.pt"),
    _mn("mn20_im", "mn20_im.pt"),
    _mn("mn30_im", "mn30_im.pt"),
    _mn("mn40_im", "mn40_im.pt"),
    # AudioSet-trained MN
    _mn("mn01_as", "mn01_as_mAP_298.pt"),
    _mn("mn02_as", "mn02_as_mAP_378.pt"),
    _mn("mn04_as", "mn04_as_mAP_432.pt"),
    _mn("mn05_as", "mn05_as_mAP_443.pt"),
    _mn("mn10_as", "mn10_as_mAP_471.pt"),
    _mn("mn20_as", "mn20_as_mAP_478.pt"),
    _mn("mn30_as", "mn30_as_mAP_482.pt"),
    _mn("mn40_as", "mn40_as_mAP_484.pt"),
    _mn("mn40_as(2)", "mn40_as_mAP_483.pt"),
    _mn("mn40_as(3)", "mn40_as_mAP_483(2).pt"),
    _mn("mn40_as_no_im_pre", "mn40_as_no_im_pre_mAP_483.pt"),
    _mn("mn40_as_no_im_pre(2)", "mn40_as_no_im_pre_mAP_483(2).pt"),
    _mn("mn40_as_no_im_pre(3)", "mn40_as_no_im_pre_mAP_482.pt"),
    _mn("mn40_as_ext", "mn40_as_ext_mAP_487.pt"),
    _mn("mn40_as_ext(2)", "mn40_as_ext_mAP_486.pt"),
    _mn("mn40_as_ext(3)", "mn40_as_ext_mAP_485.pt"),
    # hop-size variants (hop in ms at 32 kHz)
    _mn("mn10_as_hop_5", "mn10_as_hop_5_mAP_475.pt", mel=MelConfig(hopsize=160)),
    _mn("mn10_as_hop_15", "mn10_as_hop_15_mAP_463.pt", mel=MelConfig(hopsize=480)),
    _mn("mn10_as_hop_20", "mn10_as_hop_20_mAP_456.pt", mel=MelConfig(hopsize=640)),
    _mn("mn10_as_hop_25", "mn10_as_hop_25_mAP_447.pt", mel=MelConfig(hopsize=800)),
    # mel-band variants
    _mn("mn10_as_mels_40", "mn10_as_mels_40_mAP_453.pt", mel=MelConfig(n_mels=40)),
    _mn("mn10_as_mels_64", "mn10_as_mels_64_mAP_461.pt", mel=MelConfig(n_mels=64)),
    _mn("mn10_as_mels_256", "mn10_as_mels_256_mAP_474.pt", mel=MelConfig(n_mels=256)),
    # fully-convolutional heads (and stride variants)
    _mn("mn10_as_fc", "mn10_as_fc_mAP_465.pt", head="fully_convolutional"),
    _mn("mn10_as_fc_s2221", "mn10_as_fc_s2221_mAP_466.pt",
        head="fully_convolutional", strides=(2, 2, 2, 1)),
    _mn("mn10_as_fc_s2211", "mn10_as_fc_s2211_mAP_466.pt",
        head="fully_convolutional", strides=(2, 2, 1, 1)),
    # DyMN, ImageNet (final temperature 30)
    _dymn("dymn04_im", "dymn04_im.pt", t_max=30.0),
    _dymn("dymn10_im", "dymn10_im.pt", t_max=30.0),
    _dymn("dymn20_im", "dymn20_im.pt", t_max=30.0),
    # DyMN, AudioSet
    _dymn("dymn04_as", "dymn04_as.pt"),
    _dymn("dymn10_as", "dymn10_as.pt"),
    _dymn("dymn20_as", "dymn20_as_mAP_493.pt"),
    _dymn("dymn20_as(1)", "dymn20_as.pt"),
    _dymn("dymn20_as(2)", "dymn20_as_mAP_489.pt"),
    _dymn("dymn20_as(3)", "dymn20_as_mAP_490.pt"),
    _dymn("dymn04_replace_se_as", "dymn04_replace_se_as.pt", use_dy_blocks="replace_se"),
    _dymn("dymn10_replace_se_as", "dymn10_replace_se_as.pt", use_dy_blocks="replace_se"),
    # PaSST-S, AudioSet mAP .476 (PaSST's models/passt.py default_cfgs)
    ModelSpec("passt_s_swa_p16_128_ap476", "passt-s-f128-p16-s10-ap.476-swa.pt",
              PaSSTConfig(), release_url=PASST_RELEASE_URL),
    # HTS-AT, AudioSet mAP .471 (HTS-AT's config.py; the README's checkpoint)
    ModelSpec("htsat_tiny_as", "HTSAT_AudioSet_Saved_1.ckpt", HTSATConfig(),
              LibrosaMelConfig(), release_url=HTSAT_RELEASE_URL),
]

REGISTRY = {s.name: s for s in _SPECS}


def get_model_config(name: str) -> ModelSpec:
    if name not in REGISTRY:
        raise KeyError(f"Model name '{name}' unknown. Known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def build_model(name_or_cfg, num_classes: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """An MN, DyMN, PaSST or HTS-AT module on the CPU for a registry name or
    a config; ``num_classes`` overrides the config's class count. With
    ``generator`` the weights are upstream's init drawn from it
    (``dymn.init_weights``, which is ``mn.init_weights`` plus DyMN's banks;
    ``passt.init_weights``; ``htsat.init_weights``), else torch's default."""
    cfg = (get_model_config(name_or_cfg).model_cfg
           if isinstance(name_or_cfg, str) else name_or_cfg)
    if num_classes is not None and num_classes != cfg.num_classes:
        cfg = dataclasses.replace(cfg, num_classes=num_classes)
    if isinstance(cfg, PaSSTConfig):
        model, init = PaSST(cfg), init_passt
    elif isinstance(cfg, HTSATConfig):
        model, init = HTSAT(cfg), init_htsat
    else:
        model, init = (DyMN(cfg) if isinstance(cfg, DyMNConfig) else MN(cfg)), init_weights
    if generator is not None:
        init(model, generator)
    return model
