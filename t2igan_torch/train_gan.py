"""``python -m t2igan_torch.train_gan``: see
:mod:`t2igan_torch.train.train_gan`."""

from t2igan_torch.parallel.mesh import shutdown
from t2igan_torch.train.train_gan import main

if __name__ == "__main__":
    main()
    shutdown()
