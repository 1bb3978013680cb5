from eesen_tpu_torch.ops.ctc import ctc_loss, ctc_forward_backward, expand_labels

__all__ = ["ctc_loss", "ctc_forward_backward", "expand_labels"]
