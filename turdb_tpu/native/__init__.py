"""Native (C++) runtime components, loaded via ctypes with pure-Python
fallbacks. The reference's entire runtime is native Rust; here the device
compute path is JAX/XLA and the host hot paths (WAL checksumming) are C++.
"""

from turdb_tpu.native.build import crc64  # noqa: F401
