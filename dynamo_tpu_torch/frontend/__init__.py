"""The port's OpenAI frontend: `python -m dynamo_tpu_torch.frontend`."""
