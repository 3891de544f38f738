"""Evaluation of the port: FID features and the Fréchet distance
(:mod:`t2igan_torch.evaluation.fid`), the gen+eval path that feeds
generated images straight into the FID Inception-v3, and CLIP R-precision
(:mod:`t2igan_torch.evaluation.rprecision`)."""
