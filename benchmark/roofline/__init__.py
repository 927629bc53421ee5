"""The work of each kernel's operation: one file an operation, with the
names its kernels carry in a device trace, the operations and bytes that
its inputs need, and the least time the card could take for them
(`peaks.least_seconds`). A later implementation of the same operation is
held to the same work."""
