"""FFB6D dual-branch encoder with pixel<->point fusion.

Counterpart of gdm_tpu/models/ffb6d.py: four CNN/RandLA downsample stages
with r2p/p2r fusion, three fused upsample stages, a final upsample on both
branches and the gather of CNN features at ``choose``.  Module names are
the reference's (cnn_pre_stages, cnn_ds_stages, ..., *_fuse_*_layers), so
reference-named state dicts load as they are.

Layouts: the public input is the JAX package's dict (``rgb`` NHWC
[B, H, W, 3], points [B, N, C], index pyramids [B, M, K] int64).  CNN maps
run NCHW in channels_last memory, so the fusion layers' switch to
[B, H*W, C] and back is a free permute.  In training mode, dropout (0.3
after the PSP head, 0.15 after up_1 and up_2; gdm_tpu/models/ffb6d.py:91)
sits at index 1 of those stages' Sequentials, where the reference keeps
its drop modules; it holds no parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from gdm_tpu_torch.models.layers import (
    DenseBNAct,
    Dropout,
    gather_rows,
    randla_dense,
)
from gdm_tpu_torch.models.pspnet import PSPModule, PSPUpsample, final_layer
from gdm_tpu_torch.models.randla import (
    DilatedResBlock,
    decoder_widths,
    max_pool_neighbours,
    nearest_upsample,
)
from gdm_tpu_torch.models.resnet import Stem, resnet18_stages


def _flat(x: torch.Tensor) -> torch.Tensor:
    """NCHW map -> [B, H*W, C] (row-major pixels, as NHWC reshape)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _unflat(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> NCHW map (channels_last memory)."""
    return x.reshape(x.shape[0], h, w, x.shape[-1]).permute(0, 3, 1, 2)


def _fuse_list(c_ins, c_outs) -> nn.ModuleList:
    return nn.ModuleList(DenseBNAct(i, o) for i, o in zip(c_ins, c_outs))


class FFB6DEmb(nn.Module):
    def __init__(self, d_out=(32, 64, 128, 256)):
        super().__init__()
        layer1, layer2, layer3, layer4 = resnet18_stages()
        self.cnn_pre_stages = Stem()
        self.cnn_ds_stages = nn.ModuleList([
            layer1, layer2, nn.Sequential(layer3, layer4),
            nn.Sequential(PSPModule(512, 1024), Dropout(0.3))])
        # cnn.final serves up stage 2 and, after up_3, the last stage; it
        # is registered once, at cnn_up_stages.2.0
        self.cnn_up_stages = nn.ModuleList([
            nn.Sequential(PSPUpsample(1024, 256), Dropout(0.15)),
            nn.Sequential(PSPUpsample(256, 64), Dropout(0.15)),
            nn.Sequential(final_layer()),
            nn.Sequential(PSPUpsample(64, 64))])

        self.rndla_pre_stages = randla_dense(9, 8)
        d_in = [8] + [2 * d for d in d_out[:-1]]
        self.rndla_ds_stages = nn.ModuleList(
            DilatedResBlock(i, d) for i, d in zip(d_in, d_out))
        dec = decoder_widths(d_out)
        dec_in = [2 * d_out[-1] + 2 * d_out[-2], dec[0] + 2 * d_out[-3],
                  dec[1] + 2 * d_out[-4], dec[2] + 2 * d_out[0]]
        self.rndla_up_stages = nn.ModuleList(
            randla_dense(i, o) for i, o in zip(dec_in, dec))

        ds_rgb = (64, 128, 512, 1024)
        ds_pts = tuple(2 * d for d in d_out)
        up_rgb = (256, 64, 64)
        up_pts = (ds_pts[-2], ds_pts[-3], ds_pts[-4])
        self.ds_fuse_r2p_pre_layers = _fuse_list(ds_rgb, ds_pts)
        self.ds_fuse_r2p_fuse_layers = _fuse_list(
            [2 * c for c in ds_pts], ds_pts)
        self.ds_fuse_p2r_pre_layers = _fuse_list(ds_pts, ds_rgb)
        self.ds_fuse_p2r_fuse_layers = _fuse_list(
            [2 * c for c in ds_rgb], ds_rgb)
        self.up_fuse_r2p_pre_layers = _fuse_list(up_rgb, up_pts)
        self.up_fuse_r2p_fuse_layers = _fuse_list(
            [2 * c for c in up_pts], up_pts)
        self.up_fuse_p2r_pre_layers = _fuse_list(up_pts, up_rgb)
        self.up_fuse_p2r_fuse_layers = _fuse_list(
            [2 * c for c in up_rgb], up_rgb)

    def _cnn_up_stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if i < 3:
            return self.cnn_up_stages[i](x)
        return self.cnn_up_stages[2](self.cnn_up_stages[3](x))

    def _fuse(self, rgb0, p0, p2r_idx, r2p_idx, p2r_pre, p2r_fuse, r2p_pre,
              r2p_fuse):
        """One fusion step: point -> rgb and rgb -> point."""
        h, w = rgb0.shape[2:]
        rgb_flat = _flat(rgb0)
        p2r = nearest_upsample(p2r_pre(p0), p2r_idx)
        rgb = _unflat(p2r_fuse(torch.cat([rgb_flat, p2r], dim=-1)), h, w)
        r2p = r2p_pre(max_pool_neighbours(rgb_flat, r2p_idx))
        p = r2p_fuse(torch.cat([p0, r2p], dim=-1))
        return rgb, p

    def forward(self, inputs: dict) -> torch.Tensor:
        rgb = self.cnn_pre_stages(inputs["rgb"].permute(0, 3, 1, 2))
        p = self.rndla_pre_stages(inputs["cld_rgb_nrm"])

        ds_emb = []
        for i in range(4):
            rgb0 = self.cnn_ds_stages[i](rgb)
            f_enc = self.rndla_ds_stages[i](
                p, inputs[f"cld_xyz{i}"], inputs[f"cld_nei_idx{i}"])
            p0 = max_pool_neighbours(f_enc, inputs[f"cld_sub_idx{i}"])
            if i == 0:
                ds_emb.append(f_enc)
            rgb, p = self._fuse(
                rgb0, p0, inputs[f"p2r_ds_nei_idx{i}"],
                inputs[f"r2p_ds_nei_idx{i}"],
                self.ds_fuse_p2r_pre_layers[i],
                self.ds_fuse_p2r_fuse_layers[i],
                self.ds_fuse_r2p_pre_layers[i],
                self.ds_fuse_r2p_fuse_layers[i])
            ds_emb.append(p)

        for i in range(3):
            rgb0 = self._cnn_up_stage(i, rgb)
            f_interp = nearest_upsample(p, inputs[f"cld_interp_idx{3 - i}"])
            p0 = self.rndla_up_stages[i](
                torch.cat([ds_emb[-i - 2], f_interp], dim=-1))
            rgb, p = self._fuse(
                rgb0, p0, inputs[f"p2r_up_nei_idx{i}"],
                inputs[f"r2p_up_nei_idx{i}"],
                self.up_fuse_p2r_pre_layers[i],
                self.up_fuse_p2r_fuse_layers[i],
                self.up_fuse_r2p_pre_layers[i],
                self.up_fuse_r2p_fuse_layers[i])

        rgb = self._cnn_up_stage(3, rgb)
        f_interp = nearest_upsample(p, inputs["cld_interp_idx0"])
        p = self.rndla_up_stages[3](torch.cat([ds_emb[0], f_interp], dim=-1))

        choose = inputs["choose"]
        if choose.dim() == 3:                              # [B, 1, N]
            choose = choose[:, 0, :]
        rgb_c = gather_rows(_flat(rgb), choose)            # [B, N, 64]
        return torch.cat([rgb_c, p], dim=-1)               # [B, N, 128]
