from repro_torch.train.step import grads_and_metrics, lm_loss, make_train_step

__all__ = ["grads_and_metrics", "lm_loss", "make_train_step"]
