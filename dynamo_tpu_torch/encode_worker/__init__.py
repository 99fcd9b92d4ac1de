"""The encode worker of the port (the E of multimodal E/P/D): `python -m dynamo_tpu_torch.encode_worker`."""
