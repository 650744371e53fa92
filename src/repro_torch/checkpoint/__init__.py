"""Zero-redundancy sharded checkpointing, in the reference's on-disk
format (the port of ``repro/checkpoint``; a checkpoint either package
writes restores in the other).

* ``manifest``  -- the save/restore metadata contract (global shapes,
                   dtypes, specs, shard index bounds).
* ``sharded``   -- per-rank save of this rank's blocks, topology-free
                   resharded restore.
* ``writer``    -- async background writer (snapshot on the caller's
                   thread, stream files off the critical path).
* ``serving``   -- read-only params-group restore for a serving engine,
                   with dtype cast to the serving policy.
* ``io``        -- the (path, params, opt_state, step) facade.
"""
from repro_torch.checkpoint.io import restore, save  # noqa: F401
from repro_torch.checkpoint.serving import restore_serving_params  # noqa: F401
from repro_torch.checkpoint.manifest import (Manifest,  # noqa: F401
                                             load_manifest, merge_manifests)
from repro_torch.checkpoint.sharded import (checkpoint_complete,  # noqa: F401
                                            finalize_checkpoint,
                                            latest_checkpoint,
                                            partition_snapshot,
                                            restore_checkpoint,
                                            restore_tree, save_checkpoint,
                                            snapshot, write_snapshot)
from repro_torch.checkpoint.writer import AsyncCheckpointWriter  # noqa: F401
