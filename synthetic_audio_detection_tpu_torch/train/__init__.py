"""Training: the submodel train and eval steps and the trainer."""
