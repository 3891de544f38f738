"""Run configs of the port.

``eval_clip_bird.yml`` (evaluation), ``clip_bird_dmgan.yml`` (GAN
training) and ``damsm/bird.yml``, ``damsm/coco.yml`` (DAMSM CLIP
fine-tuning) are the JAX package's configs, copied.  :data:`EVAL_CLIP_BIRD`,
:data:`CLIP_BIRD_DMGAN` and :data:`DAMSM_BIRD` hold the same values as
dicts, for scripts that run where ``yaml`` may be missing
(``chip_smoke.py``); a test keeps each dict equal to its file.
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

CLIP_BIRD_DMGAN = {
    "CONFIG_NAME": "DMGAN", "DATASET_NAME": "birds", "DATA_DIR": "data/birds",
    "GPU_ID": 0, "WORKERS": 2, "CUDA": True,
    "TREE": {"BRANCH_NUM": 3},
    "GAN": {"DF_DIM": 32, "GF_DIM": 64, "Z_DIM": 100, "R_NUM": 2},
    "TEXT": {"EMBEDDING_DIM": 512, "CAPTIONS_PER_IMAGE": 10},
    "TRAIN": {"FLAG": True,
              "CLIP_MODEL_CHECKPOINT": "output/birds_DAMSM_CLIP/Model/clip45",
              "CLIP_MODEL_BASE": "openai/clip-vit-base-patch32",
              "NET_G": "", "B_NET_D": True, "BATCH_SIZE": 4,
              "MAX_EPOCH": 800, "SNAPSHOT_INTERVAL": 50,
              "DISCRIMINATOR_LR": 0.0002, "GENERATOR_LR": 0.0002,
              "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                         "LAMBDA": 10.0}},
}

DAMSM_BIRD = {
    "CONFIG_NAME": "DAMSM_CLIP", "DATASET_NAME": "birds",
    "DATA_DIR": "data/birds", "GPU_ID": 0, "WORKERS": 1,
    "TREE": {"BRANCH_NUM": 1, "BASE_SIZE": 224},
    "TEXT": {"EMBEDDING_DIM": 512, "CAPTIONS_PER_IMAGE": 10},
    "TRAIN": {"FLAG": True, "NET_E": "", "BATCH_SIZE": 48, "MAX_EPOCH": 100,
              "SNAPSHOT_INTERVAL": 1, "BACKBONE_LR": 0.00002,
              "LINEAR_LR": 20.0, "BASE_LR": 0.00000001, "GAMMA": 0.9,
              "STEP_SIZE_UP": 5, "RNN_GRAD_CLIP": 0.25,
              "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0}},
}
