from .mesh import (StreamMesh, gather_streams, shard_streams, split_streams,
                   stream_mesh)

__all__ = ["StreamMesh", "stream_mesh", "split_streams", "shard_streams",
           "gather_streams"]
