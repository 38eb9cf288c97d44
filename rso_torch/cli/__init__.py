"""The entry points (counterparts of rso/cli/): `python -m rso_torch.cli.demo`,
`eval`, `fleet`, `stages` and `bench`, with the reference's arguments, printed
lines and return codes.  Each runs on the GPU unless its caller passes
device="cpu", and raises where CUDA is absent."""
