"""Run configs of the port.

Every YAML of the JAX package, copied byte for byte:
``eval_clip_bird.yml`` and ``eval_clip_coco.yml`` (evaluation),
``clip_bird_dmgan.yml`` and ``clip_coco_dmgan.yml`` (GAN training against
CLIP), ``damsm/bird.yml`` and ``damsm/coco.yml`` (DAMSM CLIP fine-tuning),
and the legacy ``bird_dmgan.yml`` and ``coco_dmgan.yml`` (the reference's
RNN-encoder settings; the GAN trainers of both packages train against
CLIP only).  :data:`EVAL_CLIP_BIRD`, :data:`CLIP_BIRD_DMGAN`,
:data:`EVAL_CLIP_COCO`, :data:`CLIP_COCO_DMGAN` and :data:`DAMSM_BIRD`
hold the same values as dicts, for scripts that run where ``yaml`` may be
missing (``chip_smoke.py``); a test keeps each dict equal to its file
(``NAME`` is ``name.yml``, ``DAMSM_NAME`` is ``damsm/name.yml``).
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

EVAL_CLIP_COCO = {
    "CONFIG_NAME": "DMGAN", "DATASET_NAME": "coco", "DATA_DIR": "data/coco",
    "GPU_ID": 0, "WORKERS": 0, "B_VALIDATION": True,
    "TREE": {"BRANCH_NUM": 3},
    "GAN": {"DF_DIM": 32, "GF_DIM": 64, "Z_DIM": 100, "R_NUM": 3},
    "TEXT": {"EMBEDDING_DIM": 512, "CAPTIONS_PER_IMAGE": 5, "WORDS_NUM": 77},
    "TRAIN": {"FLAG": False,
              "CLIP_MODEL_CHECKPOINT": "output/coco_DAMSM_CLIP/Model/clip40",
              "CLIP_MODEL_BASE": "openai/clip-vit-base-patch32",
              "NET_G": "models/netG_coco", "B_NET_D": False,
              "BATCH_SIZE": 5},
}

CLIP_COCO_DMGAN = {
    "CONFIG_NAME": "DMGAN", "DATASET_NAME": "coco", "DATA_DIR": "data/coco",
    "GPU_ID": 0, "WORKERS": 4,
    "TREE": {"BRANCH_NUM": 3},
    "GAN": {"DF_DIM": 32, "GF_DIM": 64, "Z_DIM": 100, "R_NUM": 3},
    "TEXT": {"EMBEDDING_DIM": 512, "CAPTIONS_PER_IMAGE": 5},
    "TRAIN": {"FLAG": True,
              "CLIP_MODEL_CHECKPOINT": "output/coco_DAMSM_CLIP/Model/clip40",
              "CLIP_MODEL_BASE": "openai/clip-vit-base-patch32",
              "NET_G": "", "B_NET_D": True, "BATCH_SIZE": 4,
              "MAX_EPOCH": 200, "SNAPSHOT_INTERVAL": 10,
              "DISCRIMINATOR_LR": 0.0002, "GENERATOR_LR": 0.0002,
              "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                         "LAMBDA": 50.0}},
}
