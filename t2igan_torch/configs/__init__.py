"""Run configs of the port.

``eval_clip_bird.yml`` is the JAX package's evaluation config, copied.
:data:`EVAL_CLIP_BIRD` holds the same values as a dict, for scripts that run
where ``yaml`` may be missing (``chip_smoke.py``); a test keeps the two
equal.
"""

EVAL_CLIP_BIRD = {
    "CONFIG_NAME": "DMGAN", "DATASET_NAME": "birds", "DATA_DIR": "data/birds",
    "GPU_ID": 0, "WORKERS": 0, "B_VALIDATION": True,
    "TREE": {"BRANCH_NUM": 3},
    "GAN": {"DF_DIM": 32, "GF_DIM": 64, "Z_DIM": 100, "R_NUM": 2},
    "TEXT": {"EMBEDDING_DIM": 512, "CAPTIONS_PER_IMAGE": 10, "WORDS_NUM": 77},
    "TRAIN": {"FLAG": False,
              "CLIP_MODEL_CHECKPOINT": "output/birds_DAMSM_CLIP/Model/clip45",
              "CLIP_MODEL_BASE": "openai/clip-vit-base-patch32",
              "NET_G": "models/netG_bird", "B_NET_D": False,
              "BATCH_SIZE": 10},
}
