from .resnet import ResNetEncoder, encoder_channels
from .disp_net import DepthDecoder, DispNet
from .pose_net import PoseDecoder, PoseNet
from . import convert
