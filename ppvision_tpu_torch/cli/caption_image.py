"""Single-image captioning CLI with attention visualization.

Port of ``ppvision_tpu/cli/caption_image.py`` (the reference's
``eval/caption.py``): load one image, run the camera and the encoder,
beam-search a caption, and render the per-word attention maps over the
(privacy) image into a grid PNG.

Usage:
    python -m ppvision_tpu_torch.cli.caption_image --img photo.jpg \\
        --data_folder data/caption --data_name coco_5_cap_per_img_5_min_word_freq \\
        --ckpt_dir expr/caption --out attention.png [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


@torch.no_grad()
def caption_image_with_attention(cfg, encoder, decoder, camera, image, word_map, beam_size=5):
    """Returns (words, attention maps (T, P), the image the encoder saw)
    for one (H, W, 3) image in [0, 1]."""
    from ..models.captioner import beam_search
    from ..optics.lens import lens_apply

    encoder.eval()
    decoder.eval()
    param = next(decoder.parameters())
    rev = {v: k for k, v in word_map.items()}
    x = torch.as_tensor(np.asarray(image))[None]
    x = x.to(param.device, torch.promote_types(x.dtype, param.dtype))
    if camera is not None:
        lens, consts, spec = camera
        x = lens_apply(lens, consts, spec, x, mask_mode=cfg.mask_mode).sensor
    enc_out = encoder(x)
    tokens, _ = beam_search(decoder, enc_out, word_map["<start>"], word_map["<end>"], beam_size,
                            cfg.max_caption_len)
    # Re-run teacher-forced on the decoded tokens to recover the alphas.
    toks = tokens.cpu().numpy()
    end = word_map["<end>"]
    length = int(np.argmax(toks == end)) + 1 if (toks == end).any() else len(toks)
    seq = np.concatenate([[word_map["<start>"]], toks[:length]])
    out = decoder(enc_out, torch.as_tensor(seq)[None].to(param.device), torch.tensor([len(seq)]))
    words = [rev.get(int(t), "<unk>") for t in toks[:length] if int(t) != end]
    return words, out.alphas[0].cpu().numpy(), x[0].cpu().numpy()


def render_attention_grid(image, words, alphas, out_path, enc_size=36):
    """Word-by-word attention overlay grid (reference visualize_att)."""
    from PIL import Image

    from ..ops.image import resize_bilinear

    h, w = image.shape[:2]
    ncol = 5
    nrow = -(-(len(words) + 1) // ncol)
    grid = np.ones((nrow * h, ncol * w, 3), np.float32)
    base = np.clip(image, 0, 1)
    grid[:h, :w] = base
    for i in range(len(words)):
        att = torch.as_tensor(np.asarray(alphas[i], np.float32)).reshape(1, 1, enc_size, enc_size)
        att = resize_bilinear(att, (h, w))[0, 0, :, :, None].numpy()
        att = att / max(att.max(), 1e-8)
        over = base * (0.3 + 0.7 * att)
        r, c = divmod(i + 1, ncol)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = over
    img8 = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(img8).save(out_path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="caption one image and render its attention")
    p.add_argument("--img", required=True)
    p.add_argument("--data_folder", default="data/caption")
    p.add_argument("--data_name", default="coco_5_cap_per_img_5_min_word_freq")
    p.add_argument("--ckpt_dir", default="expr/caption")
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--out", default="attention.png")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    from PIL import Image

    from ..config import CaptionConfig
    from ..utils.checkpoint import StepCheckpoints
    from ..utils.device import resolve_device
    from . import caption

    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    cfg = CaptionConfig(beam_size=args.beam_size)
    with open(os.path.join(args.data_folder, f"WORDMAP_{args.data_name}.json")) as f:
        word_map = json.load(f)
    spec, consts, state = caption._setup(cfg, len(word_map) + 1, args.device)
    ckpts = StepCheckpoints(args.ckpt_dir)
    latest = ckpts.latest_step("caption_state")
    if latest is not None:
        state.load_state_dict(ckpts.load(latest, "caption_state"))

    img = Image.open(args.img).convert("RGB").resize((spec.patch_size,) * 2)
    image = np.asarray(img, np.float32) / 255.0
    words, alphas, sensor = caption_image_with_attention(
        cfg, state.encoder, state.decoder, (state.camera, consts, spec), image, word_map, args.beam_size,
    )
    print("Caption:", " ".join(words))
    render_attention_grid(sensor, words, alphas, args.out, state.encoder.encoded_image_size)
    print("Attention grid saved to", args.out)
    return words, alphas


if __name__ == "__main__":
    main()
