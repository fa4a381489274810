from repro_torch.train.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.train.step import make_train_step
