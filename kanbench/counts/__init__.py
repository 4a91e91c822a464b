"""The work each kernel's inputs require, one file a kernel (its C entry
point's name): ``WRAPPERS``, the program attributes whose calls launch it
on the main path; ``KERNELS``, the device kernels one call launches;
``count(*args, **kwargs)``, bytes and integer operations from a call's
arguments.  Inputs are counted read once and outputs written once, whatever
the kernel reads again, and only what the lookups need from the table."""
