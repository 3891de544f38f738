"""Evaluation of the port: FID features and the Fréchet distance
(:mod:`t2igan_torch.evaluation.fid`), and the gen+eval path that feeds
generated images straight into the FID Inception-v3."""
