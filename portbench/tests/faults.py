"""Faults planted in the program's timed path, each a function of a
pytest ``monkeypatch``: what a run's comparison has to catch."""

import torch


def alter_one_answer(monkeypatch):
    """One logit of one clip moved where the member produces it."""
    from efficientat_tpu_torch.infer import tag

    produce = tag._member_logits

    def altered(model, mel):
        out = produce(model, mel).clone()
        out[0, 7] += 0.05
        return out
    monkeypatch.setattr(tag, "_member_logits", altered)


def leave_out_half_the_batch(monkeypatch):
    """The member runs on the first half of the clips; the rest get its
    answers."""
    from efficientat_tpu_torch.infer import tag

    produce = tag._member_logits

    def half(model, mel):
        out = produce(model, mel[: mel.shape[0] // 2])
        return torch.cat([out, out])[: mel.shape[0]]
    monkeypatch.setattr(tag, "_member_logits", half)


def keep_the_state(monkeypatch):
    """The optimizer step returns the state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def loss_over_half_the_batch(monkeypatch):
    """The loss is the mean over the first half of the clips."""
    from efficientat_tpu_torch.train import loop

    task_loss = loop.task_loss

    def half(loss_cfg, logits, batch, mix=None):
        h = logits.shape[0] // 2
        if mix is not None:
            lam, partner = mix
            mix = (lam[:h], {k: v[:h] for k, v in partner.items()})
        return task_loss(loss_cfg, logits[:h], {k: v[:h] for k, v in batch.items()}, mix)
    monkeypatch.setattr(loop, "task_loss", half)


def roll_clip_kernels(monkeypatch):
    """DyMN's per-clip mixed kernels rolled by one clip across the batch:
    each clip's dynamic convs run with its neighbour's kernels."""
    from efficientat_tpu_torch.models import dymn

    conv = dymn.DynamicConv._conv
    monkeypatch.setattr(dymn.DynamicConv, "_conv",
                        lambda self, x, wb, bmm: conv(self, x, wb.roll(1, 0), bmm))


def zero_edge_frames(monkeypatch):
    """The reflect-pad edge frames of K1's log-mel set to 0 where
    ``mel_edges`` writes them (card only: on the CPU the log-mel takes the
    plain path)."""
    from efficientat_tpu_torch.ops import mel_kernel

    edges = mel_kernel.mel_edges

    def zeroed(out, wave, banks, cfg):
        out = edges(out, wave, banks, cfg)
        left, right = mel_kernel.edge_frames(out.shape[2], cfg.hopsize, cfg.n_fft,
                                             wave.shape[1] - 1)
        out[:, :, list(left) + list(right)] = 0.0
        return out
    monkeypatch.setattr(mel_kernel, "mel_edges", zeroed)


def skip_edge_frames(monkeypatch):
    """``mel_edges`` left out: the edge frames keep K1's clamped windows
    (card only)."""
    from efficientat_tpu_torch.ops import mel_kernel

    monkeypatch.setattr(mel_kernel, "mel_edges", lambda out, wave, banks, cfg: out)
