"""The robot-facing message layer: LCM types parsed at run time
(`lcm_types`) and the native UDP-multicast transport (`transport`)."""
from hkdmpc_tpu_torch.comm.lcm_types import LCMType, parse_lcm_file
from hkdmpc_tpu_torch.comm.transport import LCMTransport
