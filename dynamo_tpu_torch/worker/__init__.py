"""The port's engine worker (`python -m dynamo_tpu_torch.worker`)."""
