"""The ROS2 layer without ROS: messages, the in-process transport, the
estimator-output publisher, the sensor subscriber and the re-publisher
(counterpart of ``okvis2x_tpu/ros2``)."""

from okvis2x_tpu_torch.ros2.transport import LocalTransport, Transport  # noqa: F401
from okvis2x_tpu_torch.ros2.publisher import Publisher  # noqa: F401
from okvis2x_tpu_torch.ros2.republisher import RePublisher  # noqa: F401
from okvis2x_tpu_torch.ros2.subscriber import Subscriber  # noqa: F401
