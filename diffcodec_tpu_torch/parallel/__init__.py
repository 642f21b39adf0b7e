"""Multi-process parallelism of the port: the data x fsdp mesh on
torch.distributed (`mesh`) and its multi-process dry run (`dryrun`)."""
