"""The layer configurations (port of ``deeplearning4j_tpu/nn/conf/layers``):
each layer is one dataclass with its hyperparameters (JSON under the JAX
class names) and its functional ``init_params``/``forward``; autograd
derives the backward. The JAX package's exports that are ported are
re-exported here under its names."""

from deeplearning4j_torch.nn.conf.layers.base import (BaseLayer,
                                                      FeedForwardLayer,
                                                      Layer)
from deeplearning4j_torch.nn.conf.layers.core import (ActivationLayer,
                                                      AutoEncoder,
                                                      DenseLayer,
                                                      DropoutLayer,
                                                      EmbeddingLayer,
                                                      LossLayer, OutputLayer)
from deeplearning4j_torch.nn.conf.layers.convolution import (
    Convolution1DLayer, ConvolutionLayer, Deconvolution2D,
    SeparableConvolution2D, Subsampling1DLayer, SubsamplingLayer,
    Upsampling2D, ZeroPaddingLayer)
from deeplearning4j_torch.nn.conf.layers.normalization import (
    BatchNormalization, LayerNormalization, LocalResponseNormalization)
from deeplearning4j_torch.nn.conf.layers.pooling import (GlobalPoolingLayer,
                                                         PoolingType)
from deeplearning4j_torch.nn.conf.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep, RnnOutputLayer,
    SimpleRnn)
from deeplearning4j_torch.nn.conf.layers.misc import (CenterLossOutputLayer,
                                                      FrozenLayer)
from deeplearning4j_torch.nn.conf.layers.moe import MixtureOfExpertsLayer
from deeplearning4j_torch.nn.conf.layers.attention import (
    PositionalEncodingLayer, SelfAttentionLayer)

__all__ = [
    "ActivationLayer", "AutoEncoder", "BaseLayer", "BatchNormalization",
    "CenterLossOutputLayer", "Convolution1DLayer", "ConvolutionLayer",
    "Deconvolution2D", "DenseLayer", "DropoutLayer", "EmbeddingLayer",
    "FeedForwardLayer", "FrozenLayer", "GlobalPoolingLayer",
    "GravesBidirectionalLSTM", "GravesLSTM", "LSTM", "LastTimeStep", "Layer",
    "LayerNormalization", "LocalResponseNormalization", "LossLayer",
    "MixtureOfExpertsLayer", "OutputLayer", "PoolingType",
    "PositionalEncodingLayer", "RnnOutputLayer", "SelfAttentionLayer",
    "SeparableConvolution2D", "SimpleRnn", "Subsampling1DLayer",
    "SubsamplingLayer", "Upsampling2D", "ZeroPaddingLayer",
]
