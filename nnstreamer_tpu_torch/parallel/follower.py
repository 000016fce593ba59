"""A follower of the mesh world (parallel/world.py): rank 0 starts one
per further device as ``python -m nnstreamer_tpu_torch.parallel.follower
RANK SIZE PORT HOST:PORT DEVICE``; it runs rank 0's mesh commands until
told to stop. Nothing else should start it."""
import sys

from nnstreamer_tpu_torch.parallel import world

if __name__ == "__main__":
    sys.exit(world.follower_main(sys.argv[1:]))
