"""``python -m t2igan_torch.pretrain_damsm``: see
:mod:`t2igan_torch.train.pretrain_damsm`."""

from t2igan_torch.parallel.mesh import shutdown
from t2igan_torch.train.pretrain_damsm import main

if __name__ == "__main__":
    main()
    shutdown()
