"""The port's quantitative eval: Inception features, FID/IS, PRDC, KID, PPL."""

from ic_gan_tpu_torch.eval import fid, metrics, pipeline, prdc
from ic_gan_tpu_torch.eval.fid import frechet_distance, inception_score
from ic_gan_tpu_torch.eval.metrics import calc_metric, list_metrics
from ic_gan_tpu_torch.eval.prdc import compute_prdc

__all__ = ["fid", "metrics", "pipeline", "prdc", "frechet_distance",
           "inception_score", "calc_metric", "list_metrics", "compute_prdc"]
