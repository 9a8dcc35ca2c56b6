"""Toy sizes for the CPU rehearsal of each configuration family: the
cell's own files with these entries changed, small enough to run a
whole cell in seconds on a few CPU threads."""

TOY = {
    "deid": {
        "config": {"model": {"img_size": 64, "max_conv_dim": 64, "compute_dtype": "float32"},
                   "camera": {"n": 64, "zernike_terms": 10}},
        "mix": {"pool": 6, "styles": 2, "batch_size": 2, "check_batches": 2, "rate_per_s": 30.0},
    },
    "caption": {
        "config": {"vocab_size": 40, "encoder": {"stages": [1, 1, 1, 1], "compute_dtype": "float32"},
                   "caption": {"encoded_image_size": 4},
                   "lens": {"wave_res": 64, "patch_size": 32, "zernike_terms": 10, "mask_radius_px": 8}},
        "mix": {"batch_size": 4, "caption_tokens": 8, "words": [2, 4], "ring": 4, "check_steps": 3},
    },
}
